"""The pure-Python pieces around the narrow chain's forward repair, on the CPU:
the decision rule's classes (tools/backward_noise.py's classify and
case_class), the numerics rule past 512 (its l2_rule), and chip_smoke.py's
phase 14, which holds the backward kernels
at hidden_dim 128 and 256 on phase 13's cases (its checks need the card;
here they are stand-ins that record how the phase calls them)."""

import pytest
import torch

import chip_smoke
from nope_nerf_torch.ops import fused_render as F
from nope_nerf_torch.tools.backward_noise import FULL_RULE_SEEDS, case_class, classify, l2_rule


# (kernel~f64, f32 plain~f64, class): among them the first draws measured at 256 and 512
@pytest.mark.parametrize("kernel_f64, f32_f64, want", [
    (0.33, 0.2, "a"), (1.0, 2.5, "a"), (0.135, 0.083, "a"),
    (1.059, 0.066, "c"), (1.514, 0.083, "c"), (1.400, 0.035, "c"), (1.2, 1.0, "c"),
    (2.010, 1.035, "b"), (3.674, 2.514, "b")])
def test_classify_follows_the_decision_rule(kernel_f64, f32_f64, want):
    assert classify(kernel_f64, f32_f64) == want


@pytest.mark.parametrize("draws, want", [
    (["a", "a", "a", "a"], "a"), (["a", "b", "a"], "b"), (["b", "c", "a"], "c"),
    (["c"], "c")])
def test_a_case_takes_its_worst_draw(draws, want):
    assert case_class(draws) == want


@pytest.mark.parametrize("kernel_noise, want", [(1.0, "1.00"), (1.9, "1.90"), (3.0, "3.00")])
def test_l2_rule_holds_the_kernel_to_twice_the_plain_versions_distance(capsys, kernel_noise,
                                                                        want):
    """l2_rule on draws whose kernel strays from the f64 blocks by
    kernel_noise times the f32 plain version's noise, in every block: the
    ratio of their mean L2 distances, held to FULL_RULE (2.0)."""
    draws = []

    def draw(D, key, seed):
        draws.append((D, key, seed))
        gen = torch.Generator().manual_seed(seed)
        exact = {f"b{i}": torch.randn(64, generator=gen) for i in range(3)}
        noise = {k: torch.randn(64, generator=gen) * 1e-3 for k in exact}
        plain = {k: v + noise[k] for k, v in exact.items()}
        kernel = {k: v + kernel_noise * noise[k] for k, v in exact.items()}
        return kernel, plain, exact, exact

    l2_rule(torch, chip_smoke, "test rule", [640, 1024], [("one", 1), ("two", 2)], draw)
    out = capsys.readouterr().out
    assert len(draws) == 2 * 2 * FULL_RULE_SEEDS
    for D in (640, 1024):
        assert (f"test rule D={D}: per one, two: {want}, {want}, every one at most 2.0: "
                f"{kernel_noise <= 2.0}") in out


@pytest.mark.parametrize("missing", [None, "render_full", "frozen", "full"])
def test_phase_14_runs_every_hold_before_it_fails(monkeypatch, missing):
    # the widths of the narrow chain: every trained width below the wide one's (and the
    # widths past 512, phase 16's)
    assert (set(chip_smoke.NARROW_D) | set(chip_smoke.WIDE_D) | set(chip_smoke.XWIDE_D)
            == set(F.KERNEL_WIDTHS["train"]))
    assert not set(chip_smoke.NARROW_D) & set(chip_smoke.WIDE_D)
    assert max(chip_smoke.NARROW_D) == 256
    called = []

    def stand_in(name):
        def check(torch, dev, widths=chip_smoke.WIDE_D):
            called.append((name, widths))
            if name == missing:
                raise RuntimeError(f"{name} missed")
            return {name: 0.0}
        return check

    for name, attr in (("render_full", "check_wide_render_full"),
                       ("frozen", "check_wide_frozen"), ("full", "check_wide_full")):
        monkeypatch.setattr(chip_smoke, attr, stand_in(name))
    if missing is None:
        out = chip_smoke.run_narrow(None, None)
        assert set(out) == {"render_full", "frozen", "full"}
    else:
        with pytest.raises(RuntimeError, match=f"phase 14: {missing} missed"):
            chip_smoke.run_narrow(None, None)
    assert called == [(n, chip_smoke.NARROW_D) for n in ("render_full", "frozen", "full")]
