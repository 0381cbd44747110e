"""How far the order of f32 additions moves the render-backward kernel:
`python3 -m nope_nerf_torch.tools.backward_noise` from the root of a checkout,
on a machine with one NVIDIA GPU.

The kernel (csrc/render_bwd.cu) and its plain PyTorch version compute one
function: bf16 operands, f32 sums, cotangents rounded to bf16 before every
product, ReLU masks from bf16 activations. They sum in different orders, so a
rounding or a mask flips at a point now and then, and the two differ by more
than f32 round-off. On some inputs that difference passes the tolerance of the
checks (5e-3 of a weight or bias block's largest entry). This tool says
whether that is the kernel's fault or the noise of the function itself: it
holds the kernel AND the f32 plain version against the same function summed in
f64 (`render_rays_fused_bwd_plain(..., dtype=torch.float64)`: same operands,
same rounding points, exact sums). If the kernel is a faithful f32 evaluation,
its distance from the f64 yardstick is of the size of the plain version's.

Two input sets, 301 rays x 128 samples at hidden_dim 256, over occupancy
activation x head dist_alpha x renderer dist_alpha x cotangent set (16 cases):
- `wide`: ray origins N(0, 3^2), z on [0.1, 8.1], the density bias lowered by
  4 for a softplus head without dist_alpha (the train kernel's test inputs);
- `scene`: origins N(0, 0.5^2), z on [0.1, 6], the bias lowered for a softplus
  head whenever the renderer's dist_alpha is off (the inputs the backward
  kernel's card-only tests use).
Per case it prints the worst gradient block of kernel vs plain, kernel vs f64
and plain vs f64, each as a share of the checks' tolerance (chip_smoke.grad_share).

Then, for the case of each set where the kernel's rgb-hidden bias gradient
lies farthest from the f64 yardstick, it asks what the distance is made of.
That gradient is sum over points of g_h * (h > 0), and g_h depends on nothing
upstream of h but the composite's weights, so besides a fault only flipped
masks can move it. For every unit that deviates it searches the points whose
f64 pre-activation lies within MARGIN of zero for at most three whose g_h,
added where f64 masks them and removed where it keeps them, make up the
deviation. A deviation that such flips reproduce is the function's noise; one
they do not is a fault.
Prints plain text; PERF.md quotes it.
"""

from __future__ import annotations

import itertools
import os
import sys

MARGIN = 2e-3      # |pre-activation| below which a ReLU mask counts as ambiguous
N_RAYS, SAMPLES, HIDDEN, SEED = 301, 128, 256, 1
INPUT_SETS = {"wide": (3.0, 8.1), "scene": (0.5, 6.0)}


def case_inputs(torch, dev, name: str, occ: str, head_da: bool, dist_alpha: bool):
    """(params, rays, z, tgt, ncfg) of one case, seeded."""
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    from nope_nerf_torch.ops.fused_render import pack_rays, pack_targets
    spread, far = INPUT_SETS[name]
    gen = torch.Generator().manual_seed(SEED)
    v = torch.nn.functional.normalize(torch.randn(N_RAYS, 3, generator=gen), dim=1)
    rays = pack_rays(torch.randn(N_RAYS, 3, generator=gen) * spread, v, -v).to(dev)
    z = torch.sort(torch.rand(N_RAYS, SAMPLES, generator=gen) * (far - 0.1) + 0.1,
                   dim=1).values.to(dev)
    ncfg = NerfConfig(hidden_dim=HIDDEN, use_pallas=True, occ_activation=occ, dist_alpha=head_da)
    params = init_nerf_params(ncfg, gen, device=dev)
    scaled = head_da if name == "wide" else dist_alpha
    if occ == "softplus" and not scaled:
        params["density_b"] = params["density_b"] - 4.0
    mask = (torch.arange(N_RAYS) % 3 != 0).to(dev)
    tgt = pack_targets(torch.rand(N_RAYS, 3, generator=gen).to(dev),
                       (1 + 4 * torch.rand(N_RAYS, generator=gen)).to(dev), mask, 0.7 / N_RAYS,
                       0.3 / float(mask.sum()))
    return params, rays, z, tgt, ncfg


def explain_rgb_hidden_bias(torch, chip_smoke, dev, name, occ, head_da, dist_alpha) -> None:
    """Which flipped masks of the rgb-hidden layer make up the kernel's deviation
    from the f64 yardstick in that layer's bias gradient (see the module text)."""
    from nope_nerf_torch.models.nerf import bf16_round
    from nope_nerf_torch.ops.fused_render import (_plain_forward, _render_bwd_cuda, pack_weights,
                                                  render_rays_fused_bwd_plain)
    f64 = torch.float64
    params, rays, z, tgt, ncfg = case_inputs(torch, dev, name, occ, head_da, dist_alpha)
    cot = chip_smoke.bwd_cotangents(torch, params, rays, z, tgt, ncfg, dist_alpha, False)
    kernel = _render_bwd_cuda(params, rays, z, *cot, ncfg, dist_alpha)[1][10].to(f64)
    exact = render_rays_fused_bwd_plain(params, rays, z, *cot, ncfg, dist_alpha, dtype=f64)[1][10]
    W, B = pack_weights(params, ncfg)
    Wf = [w.to(f64) for w in W]
    fwd = _plain_forward(Wf, B, rays, z, ncfg, dist_alpha, f64)
    n, S = z.shape
    feat = fwd["acts"][8]
    pre = ((feat @ Wf[11].t()).reshape(n, S, -1) + (fwd["de"] @ Wf[12].t())[:, None, :]
           + B[10]).reshape(n * S, -1)                                   # (T, H), f64
    rgb3 = fwd["rgb3"]
    g_rgb = (fwd["weights"][..., None] * cot[0].to(f64)[:, None, :] * rgb3 * (1.0 - rgb3))
    g_h = bf16_round(g_rgb.reshape(-1, 3)) @ Wf[13][:3]                  # unmasked, (T, H)
    tol = 5e-3 * float(exact.abs().max()) + 1e-6
    dev_units = [int(j) for j in torch.nonzero((kernel - exact).abs() > 0.25 * tol).flatten()]
    print(f"{name}, occ={occ} head_dist_alpha={head_da} dist_alpha={dist_alpha}: rgb_hidden_b, "
          f"{len(dev_units)} of {exact.numel()} units deviate from f64 by more than a quarter "
          f"of the tolerance {tol:.3g}; masks within {MARGIN} of zero count as ambiguous")
    for j in dev_units:
        d = float(kernel[j] - exact[j])
        near = torch.nonzero(pre[:, j].abs() < MARGIN).flatten()
        # a flip adds g_h where f64 masks the point, removes it where f64 keeps it
        change = torch.where(pre[near, j] > 0, -g_h[near, j], g_h[near, j])
        top = torch.argsort(change.abs(), descending=True)[:14]
        near, change = near[top].tolist(), change[top].tolist()
        best = (abs(d), ())
        for k in (1, 2, 3):
            for combo in itertools.combinations(range(len(near)), k):
                best = min(best, (abs(d - sum(change[i] for i in combo)), combo))
        left, combo = best
        margins = ", ".join(f"{abs(float(pre[near[i], j])):.1e}" for i in combo)
        print(f"  unit {j}: deviation {d / tol:+.3f} of the tolerance; {len(near)} ambiguous "
              f"points among the candidates; {len(combo)} flipped mask(s) (|pre-activation| "
              f"{margins or 'none'}) leave {left / tol:.3f} of the tolerance unexplained")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("backward_noise: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())   # chip_smoke.py sits at the root of the checkout
    import chip_smoke
    from nope_nerf_torch.ops.fused_render import (_render_bwd_cuda, render_rays_fused_bwd_plain,
                                                  unpack_grads)
    dev = torch.device("cuda")

    def named(out, ncfg):
        return dict(unpack_grads(out[0], out[1], ncfg), rays=out[2], z=out[3])

    def worst(got, ref):
        shares = {k: chip_smoke.grad_share(got[k].to(ref[k].dtype), ref[k], k in ("rays", "z"))
                  for k in ref}
        k = max(shares, key=shares.get)
        return k, shares[k], sum(s > 1.0 for s in shares.values())

    for name in INPUT_SETS:
        over = {"kernel vs plain": 0, "kernel vs f64": 0, "plain vs f64": 0}
        top = dict.fromkeys(over, 0.0)
        farthest = (0.0, None)     # the case whose rgb_hidden_b lies farthest from f64
        for occ in ("softplus", "relu"):
            for head_da in (False, True):
                for dist_alpha in (False, True):
                    for aux in (False, True):
                        params, rays, z, tgt, ncfg = case_inputs(torch, dev, name, occ, head_da,
                                                                 dist_alpha)
                        cot = chip_smoke.bwd_cotangents(torch, params, rays, z, tgt, ncfg,
                                                        dist_alpha, aux)
                        kernel = named(_render_bwd_cuda(params, rays, z, *cot, ncfg, dist_alpha),
                                       ncfg)
                        plain = named(render_rays_fused_bwd_plain(params, rays, z, *cot, ncfg,
                                                                  dist_alpha), ncfg)
                        exact = named(render_rays_fused_bwd_plain(
                            params, rays, z, *cot, ncfg, dist_alpha, dtype=torch.float64), ncfg)
                        pairs = {"kernel vs plain": worst(kernel, plain),
                                 "kernel vs f64": worst(kernel, exact),
                                 "plain vs f64": worst(plain, exact)}
                        b_share = chip_smoke.grad_share(kernel["rgb_hidden_b"].double(),
                                                        exact["rgb_hidden_b"], False)
                        farthest = max(farthest, (b_share, (occ, head_da, dist_alpha)))
                        for what, (_, share, n_over) in pairs.items():
                            over[what] += n_over
                            top[what] = max(top[what], share)
                        print(f"{name}, occ={occ} head_dist_alpha={head_da} "
                              f"dist_alpha={dist_alpha} cotangents="
                              f"{'rgb,dist,weights,alpha' if aux else 'rgb,dist'}: "
                              + "; ".join(f"{what} {share:.3f} ({k})"
                                          for what, (k, share, _) in pairs.items()))
        print(f"{name}: worst share of the tolerance over 16 cases x 28 blocks, and blocks "
              "beyond it: " + "; ".join(f"{what} {top[what]:.3f}, {over[what]} beyond"
                                        for what in over))
        explain_rgb_hidden_bias(torch, chip_smoke, dev, name, *farthest[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
