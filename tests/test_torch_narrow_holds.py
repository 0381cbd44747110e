"""The pure-Python pieces around the narrow chain's forward repair, on the CPU:
the decision rule's classes (tools/backward_noise.py's classify and
case_class), and chip_smoke.py's phase 14, which holds the backward kernels
at hidden_dim 128 and 256 on phase 13's cases (its checks need the card;
here they are stand-ins that record how the phase calls them)."""

import pytest

import chip_smoke
from nope_nerf_torch.ops import fused_render as F
from nope_nerf_torch.tools.backward_noise import case_class, classify


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


@pytest.mark.parametrize("missing", [None, "render_full", "frozen", "full"])
def test_phase_14_runs_every_hold_before_it_fails(monkeypatch, missing):
    # the widths of the narrow chain: every trained width below the wide one's
    assert set(chip_smoke.NARROW_D) | set(chip_smoke.WIDE_D) == set(F.KERNEL_WIDTHS["train"])
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
