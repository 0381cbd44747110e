"""One forward, on the CPU: the plain versions of the forward kernels (K3,
K5) and of the backward kernels (K1, K4, K6) compute the same forward, bit
for bit, as the kernels do since K3 and K5 run the backward kernels' own
forward and as the JAX kernels share `_fwd_tail`; the plain routes of the
forward kernels' check builds (`render_fwd_operands`,
`point_mlp_fwd_operands`) give the X operands the plain backward forms; and
chip_smoke.py's phase 15, with stand-ins for the backward kernels, runs
every hold and reports before it fails."""

import pytest
import torch

import chip_smoke
from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
from nope_nerf_torch.ops import fused_mlp as FM
from nope_nerf_torch.ops import fused_render as F

FLAGS = [("softplus", False, False), ("relu", True, True)]   # occ, head dist_alpha, renderer's


def _rays(gen, n, S):
    v = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=1)
    rays = F.pack_rays(torch.randn(n, 3, generator=gen) * 0.5, v, -v)
    z = torch.sort(0.1 + 5.9 * torch.rand(n, S, generator=gen), dim=1).values
    return rays, z


def _params(gen, D, occ, head_da):
    ncfg = NerfConfig(hidden_dim=D, occ_activation=occ, dist_alpha=head_da, use_pallas=True)
    params = init_nerf_params(ncfg, gen, device="cpu")
    params["density_b"] = params["density_b"] - 4.0
    return ncfg, params


def _recording(monkeypatch, module, name):
    """Wrap module.name so that every call's result is kept, in order."""
    seen = []
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        seen.append(out)
        return out
    monkeypatch.setattr(module, name, wrapper)
    return seen


@pytest.mark.parametrize("occ, head_da, dist_alpha", FLAGS)
@pytest.mark.parametrize("D", [128, 384])
def test_render_plain_forward_is_the_plain_backward_forward(monkeypatch, D, occ, head_da,
                                                            dist_alpha):
    """render_rays_fused_plain's rgb, dist, weights and alpha and its MLP's
    activations and raw heads, torch.equal to those of the forward inside the
    plain K4 (_bwd_plain -> _plain_forward) and K1 (_plain_train_block)."""
    gen = torch.Generator().manual_seed(D)
    ncfg, params = _params(gen, D, occ, head_da)
    rays, z = _rays(gen, 5, 128)
    mlp = _recording(monkeypatch, F, "_mlp_forward")
    fwd = _recording(monkeypatch, F, "_plain_forward")
    rgb, dist, weights, alpha = F.render_rays_fused_plain(params, rays, z, ncfg, dist_alpha)
    g = (torch.full((5, 3), 1e-3), torch.full((5,), 1e-3))
    F._bwd_plain(params, rays, z, *g, None, None, ncfg, dist_alpha)
    tgt = F.pack_targets(torch.rand(5, 3, generator=gen), 1.0 + torch.rand(5, generator=gen),
                         torch.ones(5, dtype=torch.bool), 0.2, 0.2)
    F._train_plain(params, rays, z, tgt, ncfg, dist_alpha, 1, False)
    assert len(mlp) == 3 and len(fwd) == 2
    for other in mlp[1:]:
        for a, b in zip(mlp[0][:2] + tuple(mlp[0][2]), other[:2] + tuple(other[2])):
            assert torch.equal(a, b)
    for f in fwd:
        assert torch.equal(f["weights"], weights) and torch.equal(f["alpha"], alpha)
        assert torch.equal(f["ray_rgb"], rgb) and torch.equal(f["dist"], dist)


@pytest.mark.parametrize("occ, head_da", [f[:2] for f in FLAGS])
@pytest.mark.parametrize("D", [128, 384])
def test_point_plain_forward_is_the_plain_backward_forward(monkeypatch, D, occ, head_da):
    """point_mlp_fwd_plain's raw heads and activations torch.equal to those of
    the forward inside the plain K6 (point_mlp_bwd_plain), full and frozen."""
    gen = torch.Generator().manual_seed(D + 1)
    ncfg, params = _params(gen, D, occ, head_da)
    pts = torch.randn(131, 3, generator=gen) * 1.5
    dirs = torch.nn.functional.normalize(torch.randn(131, 3, generator=gen), dim=1)
    seen = _recording(monkeypatch, FM, "_plain_forward")
    FM.point_mlp_fwd_plain(params, pts, dirs, ncfg)
    g = (torch.full((131, 3), 1e-3), torch.full((131, 1), 1e-3))
    FM.point_mlp_bwd_plain(params, pts, dirs, *g, ncfg)
    FM.point_mlp_bwd_plain(params, pts, dirs, *g, ncfg, want_param_grads=False)
    assert len(seen) == 3
    for other in seen[1:]:
        for a, b in zip(seen[0][:2] + tuple(seen[0][2]) + seen[0][3:],
                        other[:2] + tuple(other[2]) + other[3:]):
            assert torch.equal(a, b)


def _tiled(X, names):
    return torch.cat([FM.tile_operand(X[k]).reshape(-1) for k in names])


X_NAMES = ["pe"] + [f"x{i}" for i in range(8)] + ["feat"]


@pytest.mark.parametrize("n, S", [(3, 128), (2, 256)])
@pytest.mark.parametrize("D", [128, 384])
def test_render_fwd_operands_plain_route_is_the_plain_backward_operands(D, n, S):
    """The check build's plain route: the X operands render_dw_operands forms
    for K1's and K4 full's dW products, in the kernels' tiled layout, and the
    plain version's rgb and dist."""
    gen = torch.Generator().manual_seed(D + n)
    ncfg, params = _params(gen, D, "softplus", False)
    rays, z = _rays(gen, n, S)
    rgb, dist, xops = F.render_fwd_operands(params, rays, z, ncfg)
    X, _, _ = F.render_dw_operands(params, rays, z, torch.full((n, 3), 1e-3),
                                   torch.full((n,), 1e-3), None, None, ncfg)
    assert xops.dtype == torch.bfloat16 and xops.numel() * 2 == F.render_operand_bytes(D, n, S)[0]
    assert torch.equal(xops, _tiled(X, X_NAMES))
    ref = F.render_rays_fused_plain(params, rays, z, ncfg, want_aux=False)
    assert torch.equal(rgb, ref[0]) and torch.equal(dist, ref[1])


@pytest.mark.parametrize("M", [1, 127, 130])
@pytest.mark.parametrize("D", [128, 384])
def test_point_mlp_fwd_operands_plain_route_is_the_plain_backward_operands(D, M):
    """K5's check build's plain route: the X operands point_mlp_dw_operands
    forms for K6 full's dW products (de last), tiled, and the plain outputs."""
    gen = torch.Generator().manual_seed(D + M)
    ncfg, params = _params(gen, D, "relu", True)
    pts = torch.randn(M, 3, generator=gen) * 1.5
    dirs = torch.nn.functional.normalize(torch.randn(M, 3, generator=gen), dim=1)
    rgb, density, xops = FM.point_mlp_fwd_operands(params, pts, dirs, ncfg)
    X, _ = FM.point_mlp_dw_operands(params, pts, dirs, torch.full((M, 3), 1e-3),
                                    torch.full((M, 1), 1e-3), ncfg)
    assert xops.numel() * 2 == FM.point_operand_bytes(D, M)
    assert torch.equal(xops, _tiled(X, X_NAMES + ["de"]))
    ref = FM.point_mlp_fwd_plain(params, pts, dirs, ncfg)
    assert torch.equal(rgb, ref[0]) and torch.equal(density, ref[1])


@pytest.mark.parametrize("where, want", [(None, []), ("de padding", []), ("de", ["de"]),
                                         ("x3", ["x3"]), ("pe", ["pe"])])
@pytest.mark.parametrize("D", [128, 384])
def test_operands_differ_names_each_operand_and_leaves_out_des_padding(D, where, want):
    """x_operand_views undoes x_operands' tiling operand by operand (the
    padding rows kept); chip_smoke.operands_differ names the operands whose
    own columns differ, and not de's 32 padding columns, which the kernels
    copy from shared memory as they find them and the dW kernel never reads."""
    gen = torch.Generator().manual_seed(D)
    M = 130
    ops = {"pe": torch.randn(M, 64, generator=gen), "de": torch.randn(M, 32, generator=gen)}
    ops.update({f"x{i}": torch.randn(M, D, generator=gen) for i in range(8)})
    ops["feat"] = torch.randn(M, D, generator=gen)
    ops = {k: v.to(torch.bfloat16).float() for k, v in ops.items()}
    a = F.x_operands(ops["pe"], [ops[f"x{i}"] for i in range(8)] + [ops["feat"]], ops["de"])
    views = FM.x_operand_views(a, D, M, True)
    assert list(views) == X_NAMES + ["de"]
    for k, v in views.items():
        assert torch.equal(v[:M].float(), ops[k]) and not v[M:].any()
    b = a.clone()
    tiles = -(-M // 128)
    de_at = a.numel() - tiles * 128 * 64                 # de's tile: the last operand
    if where == "de padding":
        b[de_at + 40] += 1.0                             # row 0, column 40
    elif where is not None:
        at = {"de": de_at, "pe": 0, "x3": tiles * 128 * 64 * (1 + 3 * (D // 64))}[where]
        b[at + 3] += 1.0
    assert chip_smoke.operands_differ(torch, a, b, D, M, True) == want


@pytest.mark.parametrize("fault", [None, "F1", "F2", "F3"])
def test_phase_15_runs_every_hold_before_it_fails(monkeypatch, capsys, fault):
    """Phase 15 on the CPU at a small size, the backward kernels stood in for
    by their plain versions' operands (a fault: one operand entry off in
    every call of one of them): every hold runs and prints, and the phase
    fails after the last one, naming each miss."""
    assert chip_smoke.FORWARD_D == (128, 256, 384, 512)
    monkeypatch.setattr(chip_smoke, "FORWARD_D", (128,))
    monkeypatch.setattr(chip_smoke, "FORWARD_RENDER_CASES", ((3, 128), (2, 256)))
    monkeypatch.setattr(chip_smoke, "WIDE_FULL_M", (1, 130))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)

    def spoil(xops, which):
        if which == fault:
            xops = xops.clone()
            xops[7] = xops[7] + 1.0
        return xops

    def render_bwd(params, rays, z, g_rgb, g_dist, g_w, g_a, cfg, da, operands):
        X, _, _ = F.render_dw_operands(params, rays, z, g_rgb, g_dist, g_w, g_a, cfg, da)
        operands.append(spoil(_tiled(X, X_NAMES), "F1"))

    def train(params, rays, z, tgt, cfg, da, rgb_p, white_bg, operands):
        n = rays.shape[0]
        X, _, _ = F.render_dw_operands(params, rays, z, torch.zeros(n, 3), torch.zeros(n),
                                       None, None, cfg, da)
        operands.append(spoil(_tiled(X, X_NAMES), "F2"))

    def mlp_bwd(params, pts, dirs, g_rgb, g_den, cfg, operands):
        X, _ = FM.point_mlp_dw_operands(params, pts, dirs, g_rgb, g_den, cfg)
        operands.append(spoil(_tiled(X, X_NAMES + ["de"]), "F3"))

    monkeypatch.setattr(F, "_render_bwd_cuda", render_bwd)
    monkeypatch.setattr(F, "_train_cuda", train)
    monkeypatch.setattr(FM, "_mlp_bwd_cuda", mlp_bwd)
    dev = torch.device("cpu")
    if fault is None:
        assert chip_smoke.run_one_forward(torch, dev) == {"holds": 20}
    else:
        with pytest.raises(RuntimeError, match="phase 15: missed") as err:
            chip_smoke.run_one_forward(torch, dev)
        assert str(err.value).count(fault) == 4
    out = capsys.readouterr().out
    assert out.count("one forward, D=128") == 8
    assert f"{20 - (0 if fault is None else 4)} of 20 holds" in out
