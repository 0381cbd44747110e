"""The port's YAML reader and writer (nope_nerf_torch/yaml_subset.py, behind
config.py's load_config and save_config) against PyYAML, which the card's
machine lacks and the port never imports.

- every configs/**/*.yaml, read with `yaml` blocked by a sys.meta_path
  finder: the port's load_config equals the JAX package's, the port's
  _parse_yaml equals yaml.safe_load;
- PyYAML's YAML 1.1 resolution of plain scalars, case by case;
- what the subset refuses raises ValueError naming the file and line;
- the emitter's output, read back by the port's reader and by
  yaml.safe_load, gives the dict it was given (hypothesis, printable
  strings); a string that is not printable is refused.
"""

import glob
import importlib.abc
import math
import os
import sys

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from nope_nerf_tpu.config import load_config as jax_load_config

from nope_nerf_torch import yaml_subset
from nope_nerf_torch.config import _parse_yaml, load_config, save_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO)
                 for p in glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"),
                                    recursive=True))


class _BlockYaml(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "yaml" or name.startswith("yaml."):
            raise ImportError(f"{name} is blocked: the port must not import PyYAML")
        return None


@pytest.fixture
def no_yaml(monkeypatch):
    """`import yaml` raises; the module PyYAML's users already hold stays theirs."""
    for name in [m for m in sys.modules if m == "yaml" or m.startswith("yaml.")]:
        monkeypatch.delitem(sys.modules, name)
    finder = _BlockYaml()
    sys.meta_path.insert(0, finder)
    yield
    sys.meta_path.remove(finder)
    assert "yaml" not in sys.modules


def test_every_shipped_config_is_listed():
    assert len(CONFIGS) == 69


@pytest.mark.parametrize("rel", CONFIGS)
def test_shipped_config_reads_without_pyyaml(rel, no_yaml):
    path = os.path.join(REPO, rel)
    want = jax_load_config(path)          # nope_nerf_tpu.config holds its own yaml module
    with open(path) as f:
        text = f.read()
    raw = yaml.safe_load(text)            # as does this file
    assert load_config(path) == want
    assert _parse_yaml(text, path) == raw


RESOLVER_CASES = {
    "exponent_without_dot": "a: 1e-4\nb: 1.0e-4\nc: 1.0e4\nd: 1.5E+3\n",
    "bools": "a: yes\nb: No\nc: ON\nd: off\ne: True\nf: FALSE\ng: y\nh: Yes please\n",
    "nulls": "a: ~\nb:\nc: null\nd: NULL\ne: Null\nf: nil\n",
    "quoted_true": "a: 'true'\nb: \"yes\"\nc: '1'\nd: \"~\"\ne: ''\n",
    "hash_inside_quotes": "a: 'x # y'  # c\nb: \"x # y\" # c\nc: b#c\nd: x # y\n",
    "nested_flow": "a: {b: [1, {c: 2, d: [x, 'y z']}], e: {}, f: []}\n"
                   "g: [[1, 2], [], {h: null}]\n",
    "flow_over_lines": "pose: {learn_pose: true, init_R_only: false,\n"
                       "  learn_R: false}  # trailing\nr: [1,\n  2, # two\n  3]\n",
    "block_list_under_mapping": "a:\n  b:\n  - 1\n  - 0\n  c:\n    - x\n    - 'y'\nd: 1\n",
    "json_quoted_keys": '{\n  "a": {"b": [1, 0, 1, 0], "c": "out/x y", "d": 1.0e-05},\n'
                        '  "e": true, "f": null, "g": -2\n}\n',
    "ints": "a: 0x1F\nb: 0o17\nc: 017\nd: 1_000\ne: +5\nf: -0\ni: 09\nj: -0x_1\n",
    "floats": "a: .inf\nb: -.inf\nc: +.Inf\nd: 1.\ne: .5\nf: 1_0.5\nh: -1.5e-3\n"
              "i: 6.02e23\n",
    "strings": "a: hello world\nb: it's\nc: x:y\nd: -x\ne: '-'\nf: ?x\ng: a  b\n",
    "sequences": "s:\n- 1\n- - 2\n  - 3\n- a: 1\n  b: [4]\n-\n  - 5\n- ''\n",
    "keys": "1: a\ntrue: b\n'no': c\n\"x y\": d\n3.5: e\n~: f\n",
    "escapes": "a: 'it''s'\nb: \"tab\\there \\\"q\\\" \\\\ \\/ \\n \\r \\u00e9\"\nc: 'é ü'\n",
    "document_start": "---\na: 1\n",
    "empty_document": "",
    "comments_only": "# nothing\n\n   # here\n",
    "crlf": "a: 1\r\nb:\r\n  - x\r\n",
}


@pytest.mark.parametrize("name", sorted(RESOLVER_CASES))
def test_resolver_case_matches_safe_load(name):
    text = RESOLVER_CASES[name]
    assert yaml_subset.loads(text) == yaml.safe_load(text)


def test_nan_resolves_as_safe_load():
    text = "a: .nan\nb: .NaN\nc: .NAN\nd: .Nan\n"
    got, want = yaml_subset.loads(text), yaml.safe_load(text)
    assert all(math.isnan(got[k]) and math.isnan(want[k]) for k in "abc")
    assert got["d"] == want["d"] == ".Nan"


REFUSALS = {
    "anchor": ("a: 1\nb: &x 2\n", 2),
    "alias": ("a: 1\nb: *x\n", 2),
    "tag": ("a: !!str 1\n", 1),
    "literal_block": ("a: 1\nb: |\n  text\n", 2),
    "folded_block": ("a: >\n  text\n", 1),
    "multi_line_plain": ("a: one\n  two\n", 2),
    "two_documents": ("a: 1\n---\nb: 2\n", 2),
    "timestamp": ("a: 2001-12-14\n", 1),
    "merge_key": ("a: 1\n<<: {b: 2}\n", 2),
    "explicit_key": ("? a\n: 1\n", 1),
    "multi_line_quoted": ("a: 'one\n  two'\n", 1),
    "binary_int": ("a: 1\nb: 0b101\n", 2),
    "sexagesimal_int": ("a: 1:30\n", 1),
    "sexagesimal_float": ("a: 1\nb: -1:30.5\n", 2),
    "escape_past_json": ("a: \"\\x41\"\n", 1),
    "byte_order_mark": ("\ufeffa: 1\n", 1),
    "pair_in_flow_sequence": ("a: 1\nb: [c: 1]\n", 2),
    "scalar_document": ("# top\n42\n", 2),
    "flow_sequence_document": ("[1, two, {three: 3}]\n", 1),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refused_constructs_name_the_line(name):
    text, line = REFUSALS[name]
    with pytest.raises(ValueError, match=rf"cfg\.yaml:{line}: "):
        yaml_subset.loads(text, "cfg.yaml")


def test_save_config_round_trip(tmp_path, no_yaml):
    cfg = load_config(os.path.join(REPO, "configs", "V_KITTI", "straight_d4.yaml"),
                      overrides={"training": {"out_dir": "out/a b: c", "lr": 1e-5},
                                 "extra": {"s": ["yes", "1", "", " x", "#", "é"]}})
    path = str(tmp_path / "sub" / "cfg.yaml")
    save_config(cfg, path)
    assert load_config(path) == cfg
    with open(path) as f:
        text = f.read()
    assert not text.lstrip().startswith("{")          # block YAML, not the flow form
    assert yaml.safe_load(text) == cfg               # the module object this file holds


# printable text (str.isprintable), the strings the emitter writes
_TEXT = st.text(st.characters(blacklist_categories=("Cc", "Cf", "Cs", "Co", "Cn", "Zl", "Zp",
                                                    "Zs"), whitelist_characters=" "),
                max_size=12)
_SCALARS = (st.none() | st.booleans() | st.integers(-2**70, 2**70)
            | st.floats(allow_nan=False) | _TEXT
            | st.sampled_from(["yes", "No", "~", "null", "1e-4", "0x1F", "0b1", "1:30", ".inf",
                               "a: b", "#x", "- a", "'q'", '"q"', "2001-12-14", "<<",
                               "=", "", " lead", "trail ", "it's", "\\n"]))
_KEYS = _TEXT | st.integers(-5, 5) | st.booleans() | st.none()
_TREES = st.recursive(_SCALARS, lambda kids: st.lists(kids, max_size=4)
                      | st.dictionaries(_KEYS, kids, max_size=4), max_leaves=24)


@settings(max_examples=300, deadline=None, database=None)
@given(st.dictionaries(_TEXT, _TREES, max_size=6))
def test_emitter_round_trip(tree):
    text = yaml_subset.dumps(tree)
    assert yaml_subset.loads(text) == tree
    assert yaml.safe_load(text) == tree


@pytest.mark.parametrize("text", ["line\nbreak", "tab\tin", "nel\x85", "ls\u2028", "bom\ufeff",
                                  "bell\x07"])
def test_emitter_refuses_strings_that_are_not_printable(text):
    with pytest.raises(ValueError, match="not printable"):
        yaml_subset.dumps({"a": [text]})
