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
With `--frozen`, the frozen-network variant (csrc/render_bwd_frozen.cu: the
dX chain of csrc/mlp_dx_sm90.cuh at hidden_dim 128 and 256, of
csrc/mlp_dx_wide_sm90.cuh at 384 and 512, of csrc/mlp_dx_xwide_sm90.cuh at 640
to 1024) in two parts instead:
1. the same yardstick at every width: chip_smoke.py phase 13's inputs
   (train_inputs, many_params, bwd_cotangents with all four cotangents),
   S = 128, both flag sets of WIDE_FLAGS, FROZEN_SEEDS seeds, on 133 rays
   (d(rays) has 1,197 entries, so the per-sample rule's 1 entry in 1000
   admits one) and on the pose-opt step's 1024. Per case the share of the
   per-sample rule (grad_share; <= 1 passes) and the entries off by more
   than 2e-2 of the block's largest, for kernel vs f32 plain, kernel vs f64
   and f32 plain vs f64; per width and ray count the worst shares, the
   blocks beyond the rule and the mean L2 distance from f64 of the kernel
   over that of the f32 plain version;
2. what the tensor cores' f32 accumulation does to one product: the chain's
   own products at each width (one seeded case's bf16 operands from
   render_dw_operands: the forward's trunk layers x_l = x_(l-1) W_l^T and
   the dX layers g_(l-1) = g_l W_l, K = D) computed by the wgmma dW kernel
   (dw_sm90, one chunk: one accumulator chain over K), by cuBLAS in f32
   (TF32 off: the plain version's products) and in f64. Per width: the
   mean |error| in ulps of the exact value, its mean signed part towards
   zero, the share of entries whose bf16 rounding differs from the exact
   value's, and the forward's pre-activations (+ bias in f32) whose sign
   differs from the exact one's (a flipped ReLU mask).
With `--frozen --widths 640 1024` (any widths), part 1 alone at those widths
on the pose-opt step's 1024 rays, with per width and flag set the kernel's
mean L2 distance from the f64 sum over the f32 plain version's, held to
FROZEN_RULE (2.0: at or under it the chain is a faithful f32 evaluation;
the rule for csrc/mlp_dx_xwide_sm90.cuh's chain, fixed before it first ran).
With `--full`, K6 full (csrc/point_mlp_bwd.cu) at hidden_dim 384 and 512 (or
the `--widths` given) on chip_smoke.py phase 13's inputs (point_inputs,
point_cotangents, both flag sets of WIDE_FLAGS) at its point counts
WIDE_FULL_M, FULL_SEEDS seeds: per case the worst dW or dB block by
grad_share (5e-3 of its largest entry; <= 1 passes) and the number beyond
it, for kernel vs f32 plain, kernel vs f64 (`point_mlp_bwd_plain(...,
dtype=torch.float64)`) and f32 plain vs f64; per width and point count the
worst shares, the blocks beyond the rule and the case's class (classify).
Below a few hundred points a block sums too few products for one flipped
bf16 rounding to average away: where the f32 plain version misses the 5e-3
rule against the f64 sum, no f32 evaluation can be held to it.
With `--full --widths 640 1024` (any width past 512: K6 full,
csrc/point_mlp_bwd_xwide.cu, on csrc/mlp_dx_xwide_sm90.cuh's chain with
OperandSaveX), per width and flag
set the point counts of WIDE_FULL_M from WIDE_FULL_SUM_POINTS on (196,645
points), FULL_RULE_SEEDS seeds: the mean L2 distance of the 26 dW and dB
blocks from the f64 sum (each as a share of 2e-2 of the f64 block's norm),
kernel over f32 plain, held to FULL_RULE (2.0: at or under it the kernel is
a faithful f32 evaluation; fixed before that kernel first ran).
With `--render-full` (not with `--cases` or `--attribute`), at every width
it is given (past 512 K1 and K4 full are csrc/render_train_xwide.cu and
csrc/render_bwd_xwide.cu, on csrc/mlp_dx_xwide_sm90.cuh's chain with
OperandSaveX<D, true>), `--full --widths 640 1024`'s rule (l2_rule): per
width, kernel and flag set of WIDE_FLAGS, on 1024 rays x 128 (RENDER_RULE_CASE),
FULL_RULE_SEEDS seeds, the mean L2 distance of the 26 dW and dB blocks from
the f64 sum (each as a share of 2e-2 of the f64 block's norm), kernel over
f32 plain (K1 at each side's own cotangents), held to FULL_RULE (2.0; fixed
before the kernels past 512 first ran).
Before it, at the widths given up to 512 (or at any width with
`--cases`), K1 (csrc/render_train.cu) and K4 full
(csrc/render_bwd.cu), both instances of csrc/render_full_sm90.cuh (its wide
kernel at 384 and 512), on chip_smoke.py phase
13's cases WIDE_RENDER_CASES (train_inputs, many_params, both flag sets of
WIDE_FLAGS with K1's rgb_p 1 and 2 in turn; K4 full on bwd_cotangents' four
cotangents), RENDER_FULL_SEEDS seeds: per case the worst dW or dB block by
grad_share (5e-3 of its largest entry; <= 1 passes) and the number beyond
it, for kernel vs f32 plain, kernel vs f64 and f32 plain vs f64. The f64
sum is render_rays_fused_bwd_plain(..., dtype=torch.float64) at each side's
own cotangents (K1's are the negatives of the first four columns of its
d(target), which a sign flip of a ray's colour or depth error makes differ
between the kernel and its plain version). Per width, case and kernel the
worst shares, the blocks beyond the rule and the mean L2 distance from f64
of the kernel over that of the f32 plain version, and the case's class by the
decision rule fixed before the tool's first run (classify). Then what that
distance is made of, at each width (--widths) on 1024 rays x 128 and the second flag set (relu,
dist_alpha) of each seed: per layer the bf16 activations (pe, x0..x7, feat)
that differ from the f64 forward's, per sample, for the kernel (K4 full's
own X operands, read back from the buffer it hands the dW kernel) and for
the f32 plain version; the h masks that differ; and how far one flipped h
mask at one sample can move the rgb-hidden bias gradient: the largest
single-sample term of that block over its largest entry, and the samples
whose term alone exceeds the 5e-3 rule. With `--attribute` (and `--cases`,
`--widths`, `--seeds`), on the relu / dist_alpha flag set of the same draws:
K4 full's and the f32 plain version's rgb-hidden bias gradient against the
f64 sum, then every ray alone through K4 full against f64: the ray and
column that move furthest, that move over the unmasked g_h of the sample it
matches (1 where one flipped h mask makes it), the sample's weight, and the
f64 pre-activation there in half-ulps of f32 at the sum of its terms'
magnitudes (what an f32 evaluation in any order can move it by).
With `--forward` (and `--widths`), the forward kernels K3 (csrc/render_fwd.cu)
and K5 (csrc/point_mlp_fwd.cu), which run the backward kernels' forward, on
--render-full's draws (1024 rays x 128, both flag sets of WIDE_FLAGS,
RENDER_FULL_SEEDS seeds; K5 on FORWARD_POINTS points of the scene cube drawn
after them) at every width: K3's rgb and dist and K5's rgb and density
against the f64 forward (`_plain_forward` with f64 weights: the same
bf16 operands and rounding points, exact sums) beside the f32 plain
version's distance, and, through the kernels' check builds
(render_fwd_operands, point_mlp_fwd_operands), per layer the bf16
activations (pe, x0..x7, feat; and de) that differ from the f64 forward's,
per sample, for the kernel and for the f32 plain version, with the ratio's
range per width. In a checkout without the check builds it prints the
outputs' distances only.
Prints plain text; PERF.md quotes it.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys

MARGIN = 2e-3      # |pre-activation| below which a ReLU mask counts as ambiguous
N_RAYS, SAMPLES, HIDDEN, SEED = 301, 128, 256, 1
INPUT_SETS = {"wide": (3.0, 8.1), "scene": (0.5, 6.0)}
FROZEN_WIDTHS = (128, 256, 384, 512)
FROZEN_RAYS = (133, 1024)
FROZEN_SEEDS = 6
# --frozen --widths: the kernel's mean L2 distance from the f64 sum over the f32 plain
# version's, per width and flag set, above which the chain is at fault (fixed before the
# chain past 512 first ran)
FROZEN_RULE = 2.0
FULL_SEEDS = 4
# --full past 512: seeds a flag set, and the kernel's mean L2 distance of the dW and dB
# blocks from the f64 sum over the f32 plain version's above which the kernel is at fault
FULL_RULE_SEEDS = 6
FULL_RULE = 2.0
RENDER_FULL_SEEDS = 2
RENDER_RULE_CASE = (1024, 128)   # --render-full's rule: the train step's rays x samples


def classify(kernel_f64: float, f32_f64: float) -> str:
    """The decision rule's class of one draw from the worst dW or dB block's
    share of the 5e-3 rule (<= 1 holds), kernel against the f64 sum and the
    f32 plain version against it: "a" the kernel holds against f64 in every
    block, a faithful f32 evaluation there; "b" it misses where the f32 plain
    version misses too, the draw is too small for the rule; "c" it misses
    alone, the kernel is at fault and gets fixed, the check stays."""
    if kernel_f64 <= 1.0:
        return "a"
    return "b" if f32_f64 > 1.0 else "c"


def case_class(classes) -> str:
    """A case's class from its draws': (c) if any draw is (c), else (b) if
    any is, else (a)."""
    return max(classes, key="abc".index)


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


def frozen_yardstick(torch, chip_smoke, dev, widths=FROZEN_WIDTHS, ray_counts=FROZEN_RAYS) -> None:
    """Part 1 of --frozen: K4 frozen, its f32 plain version and the f64 sum,
    at every width and ray count (see the module text)."""
    from nope_nerf_torch.ops.fused_render import _render_bwd_cuda, render_rays_fused_bwd_plain
    pairs = ("kernel~f32", "kernel~f64", "f32~f64")
    for D in widths:
        for n_rays in ray_counts:
            worst = {(p, b): 0.0 for p in pairs for b in ("rays", "z")}
            beyond = dict.fromkeys(pairs, 0)
            l2 = dict.fromkeys(pairs, 0.0)
            ratios = []
            for occ, da in chip_smoke.WIDE_FLAGS:
                flag_l2 = dict.fromkeys(pairs, 0.0)
                for seed in range(FROZEN_SEEDS):
                    gen = torch.Generator().manual_seed(100 + seed)
                    rays, z, tgt = chip_smoke.train_inputs(torch, dev, gen, n_rays, SAMPLES)
                    ncfg, params = chip_smoke.many_params(torch, dev, gen, D, occ, da, SAMPLES)
                    cot = chip_smoke.bwd_cotangents(torch, params, rays, z, tgt, ncfg, da, True)
                    k = _render_bwd_cuda(params, rays, z, *cot, ncfg, da,
                                         want_param_grads=False)[2:]
                    p32 = render_rays_fused_bwd_plain(params, rays, z, *cot, ncfg, da)[2:]
                    p64 = [t.float() for t in render_rays_fused_bwd_plain(
                        params, rays, z, *cot, ncfg, da, dtype=torch.float64)[2:]]
                    row = []
                    for b, i in (("rays", 0), ("z", 1)):
                        parts = []
                        for what, got, ref in zip(pairs, (k[i], k[i], p32[i]),
                                                  (p32[i], p64[i], p64[i])):
                            share = chip_smoke.grad_share(got, ref, True)
                            err = (got - ref).abs()
                            off = int((err > 2e-2 * float(ref.abs().max()) + 1e-6).sum())
                            norm = float(err.norm()) / (2e-2 * float(ref.norm()) + 1e-12)
                            worst[(what, b)] = max(worst[(what, b)], share)
                            beyond[what] += share > 1.0
                            l2[what] += norm
                            flag_l2[what] += norm
                            parts.append(f"{what} {share:.3f} ({off} off)")
                        row.append(f"{b}: " + ", ".join(parts))
                    print(f"frozen D={D} {n_rays} rays occ={occ} dist_alpha={da} seed {seed}: "
                          + "; ".join(row), flush=True)
                ratio = flag_l2["kernel~f64"] / flag_l2["f32~f64"]
                ratios.append(ratio)
                print(f"frozen D={D} {n_rays} rays occ={occ} dist_alpha={da}, {FROZEN_SEEDS} seeds: "
                      f"mean L2 share kernel~f64 {flag_l2['kernel~f64'] / (2 * FROZEN_SEEDS):.3f}, "
                      f"f32~f64 {flag_l2['f32~f64'] / (2 * FROZEN_SEEDS):.3f}, ratio {ratio:.2f} "
                      f"(rule: at most {FROZEN_RULE}: {ratio <= FROZEN_RULE})", flush=True)
            cases = 2 * len(chip_smoke.WIDE_FLAGS) * FROZEN_SEEDS
            print(f"frozen D={D} {n_rays} rays, summary over {cases // 2} cases: worst share "
                  + ", ".join(f"{p} rays {worst[(p, 'rays')]:.3f} z {worst[(p, 'z')]:.3f}"
                              for p in pairs)
                  + "; blocks beyond the rule " + ", ".join(f"{p} {beyond[p]}" for p in pairs)
                  + f"; mean L2 share kernel~f64 {l2['kernel~f64'] / cases:.3f}, f32~f64 "
                  f"{l2['f32~f64'] / cases:.3f}, ratio {l2['kernel~f64'] / l2['f32~f64']:.2f}; "
                  f"per flag set {', '.join(f'{r:.2f}' for r in ratios)}, every one at most "
                  f"{FROZEN_RULE}: {all(r <= FROZEN_RULE for r in ratios)}", flush=True)


def full_yardstick(torch, chip_smoke, dev, widths) -> None:
    """--full: K6 full, its f32 plain version and the f64 sum, on the dW and
    dB blocks at each width and point count (see the module text)."""
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    from nope_nerf_torch.ops.fused_mlp import _mlp_bwd_cuda, point_mlp_bwd_plain
    from nope_nerf_torch.ops.fused_render import unpack_grads
    pairs = ("kernel~f32", "kernel~f64", "f32~f64")
    for D in widths:
        for M in chip_smoke.WIDE_FULL_M:
            worst = dict.fromkeys(pairs, 0.0)
            beyond = dict.fromkeys(pairs, 0)
            classes = []
            for seed in range(FULL_SEEDS):
                gen = torch.Generator().manual_seed(200 + seed)
                pts, dirs = chip_smoke.point_inputs(torch, dev, gen, M)
                for occ, da in chip_smoke.WIDE_FLAGS:
                    ncfg = NerfConfig(hidden_dim=D, occ_activation=occ, dist_alpha=da,
                                      use_pallas=True)
                    params = init_nerf_params(ncfg, gen, device=dev)
                    cot = chip_smoke.point_cotangents(torch, params, pts, dirs, ncfg)
                    outs = [_mlp_bwd_cuda(params, pts, dirs, *cot, ncfg),
                            point_mlp_bwd_plain(params, pts, dirs, *cot, ncfg),
                            point_mlp_bwd_plain(params, pts, dirs, *cot, ncfg,
                                                dtype=torch.float64)]
                    k, p32, p64 = (unpack_grads([w.float() for w in o[0]],
                                                [b.float() for b in o[1]], ncfg) for o in outs)
                    parts, top = [], {}
                    for what, got, ref in zip(pairs, (k, k, p32), (p32, p64, p64)):
                        shares = {n: chip_smoke.grad_share(got[n], ref[n], False) for n in ref}
                        n_worst = max(shares, key=shares.get)
                        top[what] = shares[n_worst]
                        worst[what] = max(worst[what], shares[n_worst])
                        over = sum(v > 1.0 for v in shares.values())
                        beyond[what] += over
                        parts.append(f"{what} {shares[n_worst]:.3f} ({n_worst}, {over} beyond)")
                    classes.append(classify(top["kernel~f64"], top["f32~f64"]))
                    print(f"full D={D} {M} points occ={occ} head_dist_alpha={da} seed {seed}: "
                          + "; ".join(parts) + f"; class ({classes[-1]})", flush=True)
            print(f"full D={D} {M} points, summary over {FULL_SEEDS * len(chip_smoke.WIDE_FLAGS)}"
                  " cases x 26 blocks: worst share "
                  + ", ".join(f"{p} {worst[p]:.3f}" for p in pairs) + "; blocks beyond 5e-3 "
                  + ", ".join(f"{p} {beyond[p]}" for p in pairs)
                  + f"; class ({case_class(classes)})", flush=True)


def l2_rule(torch, chip_smoke, title: str, widths, subjects, draw) -> None:
    """The numerics rule past 512 (see the module text): for each width D and
    (text, key) of `subjects`, over FULL_RULE_SEEDS seeds, draw(D, key, seed)
    gives the kernel's, its f32 plain version's and the f64 sum's dW and dB
    blocks (the f64 sum at the kernel's and at the plain version's own
    cotangents): their mean L2 shares, kernel~f64 over f32~f64 against
    FULL_RULE."""
    pairs = ("kernel~f32", "kernel~f64", "f32~f64")
    for D in widths:
        ratios = []
        for text, key in subjects:
            l2 = dict.fromkeys(pairs, 0.0)
            worst = dict.fromkeys(pairs, 0.0)
            by_block = {}   # kernel~f64 L2 share per block, summed over the seeds
            for seed in range(FULL_RULE_SEEDS):
                K, P, EK, EP = draw(D, key, seed)
                parts = []
                for what, got, ref in zip(pairs, (K, K, P), (P, EK, EP)):
                    shares = l2_shares(got, ref)
                    mean = sum(shares.values()) / len(shares)
                    l2[what] += mean
                    if what == "kernel~f64":
                        for b, v in shares.items():
                            by_block[b] = by_block.get(b, 0.0) + v
                    worst[what] = max(worst[what], max(
                        chip_smoke.grad_share(got[b], ref[b], False) for b in ref))
                    parts.append(f"{what} mean L2 share {mean:.4f}")
                print(f"{title} D={D} {text} seed {seed}: " + "; ".join(parts), flush=True)
            ratio = l2["kernel~f64"] / l2["f32~f64"]
            ratios.append(ratio)
            print(f"{title} D={D} {text}, {FULL_RULE_SEEDS} seeds: mean L2 share kernel~f64 "
                  f"{l2['kernel~f64'] / FULL_RULE_SEEDS:.4f}, f32~f64 "
                  f"{l2['f32~f64'] / FULL_RULE_SEEDS:.4f}, kernel~f32 "
                  f"{l2['kernel~f32'] / FULL_RULE_SEEDS:.4f}; ratio {ratio:.2f} (rule: at "
                  f"most {FULL_RULE}: {ratio <= FULL_RULE}); worst block by 5e-3: "
                  + ", ".join(f"{q} {worst[q]:.3f}" for q in pairs) + "; kernel~f64 "
                  "farthest blocks " + ", ".join(
                      f"{b} {v / FULL_RULE_SEEDS:.4f}" for b, v in
                      sorted(by_block.items(), key=lambda kv: -kv[1])[:4]), flush=True)
            torch.cuda.empty_cache()
        print(f"{title} D={D}: per {', '.join(text for text, _ in subjects)}: "
              f"{', '.join(f'{r:.2f}' for r in ratios)}, every one at most {FULL_RULE}: "
              f"{all(r <= FULL_RULE for r in ratios)}", flush=True)


def full_rule(torch, chip_smoke, dev, widths) -> None:
    """--full past 512: K6 full's rule (l2_rule) per width, point count of
    WIDE_FULL_M from WIDE_FULL_SUM_POINTS on and flag set."""
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    from nope_nerf_torch.ops.fused_mlp import _mlp_bwd_cuda, point_mlp_bwd_plain
    from nope_nerf_torch.ops.fused_render import unpack_grads

    def draw(D, key, seed):
        M, occ, da = key
        gen = torch.Generator().manual_seed(400 + seed)
        pts, dirs = chip_smoke.point_inputs(torch, dev, gen, M)
        ncfg = NerfConfig(hidden_dim=D, occ_activation=occ, dist_alpha=da, use_pallas=True)
        params = init_nerf_params(ncfg, gen, device=dev)
        cot = chip_smoke.point_cotangents(torch, params, pts, dirs, ncfg)
        k, p, e = (unpack_grads([w.float() for w in o[0]], [b.float() for b in o[1]], ncfg)
                   for o in (_mlp_bwd_cuda(params, pts, dirs, *cot, ncfg),
                             point_mlp_bwd_plain(params, pts, dirs, *cot, ncfg),
                             point_mlp_bwd_plain(params, pts, dirs, *cot, ncfg,
                                                 dtype=torch.float64)))
        return k, p, e, e

    subjects = [(f"{M} points occ={occ} head_dist_alpha={da}", (M, occ, da))
                for M in chip_smoke.WIDE_FULL_M if M >= chip_smoke.WIDE_FULL_SUM_POINTS
                for occ, da in chip_smoke.WIDE_FLAGS]
    l2_rule(torch, chip_smoke, "full rule", widths, subjects, draw)


def l2_shares(got: dict, ref: dict) -> dict:
    """{block: its L2 distance from `ref` as a share of 2e-2 of ref's norm}."""
    return {n: float((got[n] - ref[n]).norm()) / (2e-2 * float(ref[n].norm()) + 1e-12)
            for n in ref}


def render_full_rule(torch, chip_smoke, dev, widths) -> None:
    """--render-full's rule (l2_rule) per width, kernel (K1 at each side's
    own cotangents, K4 full on bwd_cotangents') and flag set, on
    RENDER_RULE_CASE."""
    from nope_nerf_torch.ops.fused_render import (_render_bwd_cuda, _train_cuda, _train_plain,
                                                  render_rays_fused_bwd_plain, unpack_grads)
    n, S = RENDER_RULE_CASE

    def exact(params, rays, z, cot, ncfg, da):
        return render_rays_fused_bwd_plain(params, rays, z, *cot, ncfg, da,
                                           dtype=torch.float64)[:2]

    def own_cotangents(dtgt):
        return (-dtgt[:, 0:3]).contiguous(), (-dtgt[:, 3]).contiguous(), None, None

    def draw(D, key, seed):
        kname, occ, da, rgb_p = key
        gen = torch.Generator().manual_seed(500 + seed)
        rays, z, tgt = chip_smoke.train_inputs(torch, dev, gen, n, S)
        ncfg, params = chip_smoke.many_params(torch, dev, gen, D, occ, da, S)
        if kname == "render_train":
            k = _train_cuda(params, rays, z, tgt, ncfg, da, rgb_p, False)
            p = _train_plain(params, rays, z, tgt, ncfg, da, rgb_p, False)
            e_k = exact(params, rays, z, own_cotangents(k[5]), ncfg, da)
            e_p = (e_k if torch.equal(k[5][:, :4], p[5][:, :4])
                   else exact(params, rays, z, own_cotangents(p[5]), ncfg, da))
            k, p = k[1:3], p[1:3]
        else:
            cot = chip_smoke.bwd_cotangents(torch, params, rays, z, tgt, ncfg, da, True)
            k = _render_bwd_cuda(params, rays, z, *cot, ncfg, da)[:2]
            p = render_rays_fused_bwd_plain(params, rays, z, *cot, ncfg, da)[:2]
            e_k = e_p = exact(params, rays, z, cot, ncfg, da)
        return tuple(unpack_grads([w.float() for w in o[0]], [b.float() for b in o[1]], ncfg)
                     for o in (k, p, e_k, e_p))

    subjects = [(f"{kname} {n} rays x {S} occ={occ} dist_alpha={da}", (kname, occ, da, rgb_p))
                for kname in ("render_train", "render_bwd")
                for (occ, da), rgb_p in zip(chip_smoke.WIDE_FLAGS, (1, 2))]
    l2_rule(torch, chip_smoke, "render rule", widths, subjects, draw)


def render_full_yardstick(torch, chip_smoke, dev, widths=FROZEN_WIDTHS, cases=None,
                          seeds=RENDER_FULL_SEEDS, flags=None) -> None:
    """--render-full: K1 and K4 full, their f32 plain versions and the f64
    sum, on the dW and dB blocks at every width on phase 13's cases, or on
    the given widths, (rays, S) cases, seed count and flag sets (indices
    into WIDE_FLAGS) (see the module text)."""
    from nope_nerf_torch.ops.fused_render import (_render_bwd_cuda, _train_cuda, _train_plain,
                                                  render_rays_fused_bwd_plain, unpack_grads)
    pairs = ("kernel~f32", "kernel~f64", "f32~f64")

    def exact(params, rays, z, cot, ncfg, da):
        return render_rays_fused_bwd_plain(params, rays, z, *cot, ncfg, da,
                                           dtype=torch.float64)[:2]

    def own_cotangents(dtgt):
        return (-dtgt[:, 0:3]).contiguous(), (-dtgt[:, 3]).contiguous(), None, None

    flags = range(len(chip_smoke.WIDE_FLAGS)) if flags is None else flags
    for D in widths:
        for n, S in chip_smoke.WIDE_RENDER_CASES if cases is None else cases:
            for kname in ("render_train", "render_bwd"):
                worst = dict.fromkeys(pairs, 0.0)
                beyond = dict.fromkeys(pairs, 0)
                l2 = dict.fromkeys(pairs, 0.0)
                classes = []
                for seed in range(seeds):
                    gen = torch.Generator().manual_seed(300 + seed)
                    rays, z, tgt = chip_smoke.train_inputs(torch, dev, gen, n, S)
                    for f, ((occ, da), rgb_p) in enumerate(zip(chip_smoke.WIDE_FLAGS, (1, 2))):
                        ncfg, params = chip_smoke.many_params(torch, dev, gen, D, occ, da, S)
                        if f not in flags:
                            continue
                        note = ""
                        if kname == "render_train":
                            k = _train_cuda(params, rays, z, tgt, ncfg, da, rgb_p, False)
                            p = _train_plain(params, rays, z, tgt, ncfg, da, rgb_p, False)
                            same = torch.equal(k[5][:, :4], p[5][:, :4])
                            e_k = exact(params, rays, z, own_cotangents(k[5]), ncfg, da)
                            e_p = e_k if same else exact(params, rays, z, own_cotangents(p[5]),
                                                         ncfg, da)
                            note = f" rgb_p={rgb_p}, cotangents equal {same}"
                            k, p = k[1:3], p[1:3]
                        else:
                            cot = chip_smoke.bwd_cotangents(torch, params, rays, z, tgt, ncfg,
                                                            da, True)
                            k = _render_bwd_cuda(params, rays, z, *cot, ncfg, da)[:2]
                            p = render_rays_fused_bwd_plain(params, rays, z, *cot, ncfg, da)[:2]
                            e_k = e_p = exact(params, rays, z, cot, ncfg, da)
                        K, P, EK, EP = (unpack_grads([w.float() for w in o[0]],
                                                     [b.float() for b in o[1]], ncfg)
                                        for o in (k, p, e_k, e_p))
                        parts, top = [], {}
                        for what, got, ref in zip(pairs, (K, K, P), (P, EK, EP)):
                            shares = {b: chip_smoke.grad_share(got[b], ref[b], False) for b in ref}
                            b_worst = max(shares, key=shares.get)
                            over = sum(v > 1.0 for v in shares.values())
                            top[what] = shares[b_worst]
                            worst[what] = max(worst[what], shares[b_worst])
                            beyond[what] += over
                            l2[what] += sum(float((got[b] - ref[b]).norm())
                                            / (float(ref[b].norm()) + 1e-30) for b in ref)
                            parts.append(f"{what} {shares[b_worst]:.3f} ({b_worst}, "
                                         f"{over} beyond)")
                        classes.append(classify(top["kernel~f64"], top["f32~f64"]))
                        print(f"{kname} D={D} {n} rays x {S} occ={occ} dist_alpha={da}{note} "
                              f"seed {seed}: " + "; ".join(parts) + f"; class ({classes[-1]})",
                              flush=True)
                        del k, p, e_k, e_p
                runs = seeds * len(flags)
                print(f"{kname} D={D} {n} rays x {S}, summary over {runs} cases x 26 blocks: "
                      "worst share " + ", ".join(f"{q} {worst[q]:.3f}" for q in pairs)
                      + "; blocks beyond 5e-3 " + ", ".join(f"{q} {beyond[q]}" for q in pairs)
                      + f"; mean relative L2 distance from f64, kernel over f32 plain "
                      f"{l2['kernel~f64'] / max(l2['f32~f64'], 1e-30):.2f}"
                      f"; class ({case_class(classes)})", flush=True)
                torch.cuda.empty_cache()


def render_full_flips(torch, chip_smoke, dev, widths=FROZEN_WIDTHS) -> None:
    """Part 2 of --render-full: per layer, the kernel's and the f32 plain
    version's bf16 activations that differ from the f64 forward's, and the
    rgb-hidden bias gradient's sensitivity to one flipped h mask (see the
    module text)."""
    from nope_nerf_torch.ops import fused_mlp as FM
    from nope_nerf_torch.ops import fused_render as F
    n, S = 1024, 128
    names = ["pe"] + [f"x{i}" for i in range(8)] + ["feat"]
    for D in widths:
        for seed in range(RENDER_FULL_SEEDS):
            gen = torch.Generator().manual_seed(300 + seed)   # the yardstick's draws
            rays, z, tgt = chip_smoke.train_inputs(torch, dev, gen, n, S)
            chip_smoke.many_params(torch, dev, gen, D, *chip_smoke.WIDE_FLAGS[0], S)
            occ, da = chip_smoke.WIDE_FLAGS[1]
            ncfg, params = chip_smoke.many_params(torch, dev, gen, D, occ, da, S)
            cot = chip_smoke.bwd_cotangents(torch, params, rays, z, tgt, ncfg, da, True)
            # K4 full, keeping the X operands it hands the dW kernel
            kept = []
            F._render_bwd_cuda(params, rays, z, *cot, ncfg, da, operands=kept)
            torch.cuda.synchronize()
            xk = kept[0]
            W, B = F.pack_weights(params, ncfg)
            acts = {}
            for dtype in (torch.float32, torch.float64):
                Wf = [w.to(dtype) for w in W]
                parts = [F._plain_forward(Wf, B, rays[i:i + 256], z[i:i + 256], ncfg, da, dtype)
                         for i in range(0, n, 256)]
                acts[dtype] = {name: torch.cat([p["pe"] if name == "pe" else
                                                p["acts"][names.index(name) - 1]
                                                for p in parts]).float() for name in names}
                acts[dtype]["h"] = torch.cat([p["acts"][9] for p in parts]).float()
            at, rows = 0, []
            for name in names:
                ref = FM.tile_operand(acts[torch.float64][name])
                mine = xk[at:at + ref.numel()].view(ref.shape)
                at += ref.numel()
                plain = FM.tile_operand(acts[torch.float32][name])
                rows.append(f"{name} {int((mine != ref).sum()) / (n * S):.3g} / "
                            f"{int((plain != ref).sum()) / (n * S):.3g}")
            h_flips = int(((acts[torch.float32]["h"] > 0) != (acts[torch.float64]["h"] > 0)).sum())
            # the rgb-hidden bias gradient's terms, one a sample (f64 backward's masked g_h)
            taps = {}
            Wf = [w.double() for w in W]
            fwd = F._plain_forward(Wf, B, rays[:256], z[:256], ncfg, da, torch.float64)
            _, dBs, _, _ = F._plain_backward_tail(Wf, rays[:256].double(), z[:256].double(), fwd,
                                                  ncfg, da, *(None if c is None else
                                                              c[:256].double() for c in cot),
                                                  False, taps)
            block = F._bwd_plain(params, rays, z, *cot, ncfg, da, dtype=torch.float64)[1][10]
            g_rgb = taps["g_rgb"]
            terms = ((g_rgb @ Wf[13][:3]) * (fwd["acts"][9] > 0)).abs()
            share = terms / block.abs().max()
            print(f"flips D={D} {n} rays x {S} occ={occ} dist_alpha={da} seed {seed}: bf16 "
                  "activations differing from f64 a sample, kernel / f32 plain: "
                  + ", ".join(rows) + f"; h masks differing (f32 plain) {h_flips}; one flipped h "
                  f"mask moves rgb_hidden_b by up to {float(share.max()) / 5e-3:.2f} of its "
                  f"tolerance, {int((share > 5e-3).any(dim=1).sum())} of the first 256 rays' "
                  f"{256 * S} samples by more than it", flush=True)
            del kept, xk, acts
            torch.cuda.empty_cache()


X_NAMES = ["pe"] + [f"x{i}" for i in range(8)] + ["feat"]
FORWARD_POINTS = 65_536     # K5's points a draw: one block of the plain version


def _flips(torch, got: dict, acts64: dict, rows: int) -> dict:
    """Per operand of `got` ({name: bf16-valued tensor, its first `rows`
    rows the points'}), the share of its activations whose bf16 value
    differs from the f64 forward's, per row."""
    return {name: int((v[:rows].to(torch.bfloat16) != acts64[name].to(torch.bfloat16)).sum())
            / rows for name, v in got.items()}


def forward_flips(torch, chip_smoke, dev, widths=FROZEN_WIDTHS, seeds=RENDER_FULL_SEEDS) -> None:
    """--forward: K3 and K5 against the f64 forward (see the module text)."""
    from nope_nerf_torch.models.nerf import NerfConfig, init_nerf_params
    from nope_nerf_torch.ops import fused_mlp as FM
    from nope_nerf_torch.ops import fused_render as F
    check = hasattr(F, "render_fwd_operands")   # a checkout before it has no check build
    n, S = 1024, 128
    for D in widths:
        ratios = {"K3": [], "K5": []}
        for seed in range(seeds):
            gen = torch.Generator().manual_seed(300 + seed)   # --render-full's draws
            rays, z, _ = chip_smoke.train_inputs(torch, dev, gen, n, S)
            for occ, da in chip_smoke.WIDE_FLAGS:
                ncfg, params = chip_smoke.many_params(torch, dev, gen, D, occ, da, S)
                W, B = F.pack_weights(params, ncfg)
                ref = {}
                for dtype in (torch.float32, torch.float64):
                    Wf = [w.to(dtype) for w in W]
                    parts = [F._plain_forward(Wf, B, rays[i:i + 256], z[i:i + 256], ncfg, da,
                                              dtype) for i in range(0, n, 256)]
                    ref[dtype] = {"rgb": torch.cat([p["ray_rgb"] for p in parts]),
                                  "dist": torch.cat([p["dist"] for p in parts])}
                    ref[dtype].update({name: torch.cat([p["pe"] if name == "pe" else
                                                        p["acts"][X_NAMES.index(name) - 1]
                                                        for p in parts]) for name in X_NAMES})
                if check:
                    rgb, dist, xk = F.render_fwd_operands(params, rays, z, ncfg, da)
                else:
                    rgb, dist, _, _ = F.render_rays_fused(params, rays, z, ncfg, da,
                                                          want_aux=False)
                e64 = ref[torch.float64]
                dists = []
                for what in ("rgb", "dist"):
                    k = float((rgb if what == "rgb" else dist).double().sub(e64[what]).abs().max())
                    p = float(ref[torch.float32][what].double().sub(e64[what]).abs().max())
                    dists.append(f"{what} max |K3 - f64| {k:.3g}, |f32 plain - f64| {p:.3g}")
                text = "; ".join(dists)
                if check:
                    kf = _flips(torch, FM.x_operand_views(xk, D, n * S, False), e64, n * S)
                    pf = _flips(torch, {k: ref[torch.float32][k] for k in X_NAMES}, e64, n * S)
                    ratios["K3"] += [kf[k] / max(pf[k], 1e-12) for k in X_NAMES[1:]]
                    text += "; bf16 activations off the f64 forward's a sample, K3 / f32 plain: " \
                        + ", ".join(f"{k} {kf[k]:.3g} / {pf[k]:.3g}" for k in X_NAMES)
                print(f"forward D={D} {n} rays x {S} occ={occ} dist_alpha={da} seed {seed}: "
                      + text, flush=True)
                # K5 on points of the scene cube at the same width and flags
                pts, dirs = chip_smoke.point_inputs(torch, dev, gen, FORWARD_POINTS)
                pcfg = NerfConfig(hidden_dim=D, occ_activation=occ, dist_alpha=da,
                                  use_pallas=True)
                pparams = init_nerf_params(pcfg, gen, device=dev)
                PW, PB = F.pack_weights(pparams, pcfg)
                pref = {}
                for dtype in (torch.float32, torch.float64):
                    rgb_raw, sig_raw, acts, pe, de = FM._plain_forward(
                        [w.to(dtype) for w in PW], PB, pts, dirs)
                    pref[dtype] = dict(zip(X_NAMES + ["de"], [pe] + list(acts[:9]) + [de]))
                    pref[dtype]["rgb"], pref[dtype]["density"] = FM._heads(rgb_raw, sig_raw,
                                                                            pcfg)
                if check:
                    prgb, pden, pxk = FM.point_mlp_fwd_operands(pparams, pts, dirs, pcfg)
                else:
                    with torch.no_grad():
                        prgb, pden = FM.point_mlp(pparams, pts, dirs, pcfg)
                p64 = pref[torch.float64]
                dists = []
                for what, got in (("rgb", prgb), ("density", pden)):
                    k = float(got.double().sub(p64[what]).abs().max())
                    p = float(pref[torch.float32][what].double().sub(p64[what]).abs().max())
                    dists.append(f"{what} max |K5 - f64| {k:.3g}, |f32 plain - f64| {p:.3g}")
                text = "; ".join(dists)
                if check:
                    kf = _flips(torch, FM.x_operand_views(pxk, D, FORWARD_POINTS, True), p64,
                                FORWARD_POINTS)
                    pf = _flips(torch, {k: pref[torch.float32][k] for k in X_NAMES}, p64,
                                FORWARD_POINTS)
                    ratios["K5"] += [kf[k] / max(pf[k], 1e-12) for k in X_NAMES[1:]]
                    text += "; bf16 activations off the f64 forward's a point, K5 / f32 plain: " \
                        + ", ".join(f"{k} {kf[k]:.3g} / {pf[k]:.3g}" for k in X_NAMES)
                print(f"forward D={D} {FORWARD_POINTS} points occ={occ} head_dist_alpha={da} "
                      f"seed {seed}: " + text, flush=True)
                torch.cuda.empty_cache()
        if check:
            print(f"forward D={D}: flips, kernel over f32 plain, x0 to feat over both flag sets "
                  f"and {seeds} seeds: " + "; ".join(
                      f"{k} {min(v):.2f} to {max(v):.2f}" for k, v in ratios.items() if v),
                  flush=True)


def render_full_attribution(torch, chip_smoke, dev, widths, cases, seeds) -> None:
    """--render-full --attribute: where K4 full's rgb-hidden bias gradient
    leaves the f64 sum, on the relu / dist_alpha flag set of the yardstick's
    draws (see the module text)."""
    from nope_nerf_torch.ops import fused_render as F
    occ, da = chip_smoke.WIDE_FLAGS[1]
    blk = "rgb_hidden_b"

    def bias_grad(out, ncfg):
        return F.unpack_grads([w.float() for w in out[0]], [b.float() for b in out[1]],
                              ncfg)[blk]

    for D in widths:
        for n, S in cases:
            for seed in range(seeds):
                gen = torch.Generator().manual_seed(300 + seed)   # the yardstick's draws
                rays, z, tgt = chip_smoke.train_inputs(torch, dev, gen, n, S)
                chip_smoke.many_params(torch, dev, gen, D, *chip_smoke.WIDE_FLAGS[0], S)
                ncfg, params = chip_smoke.many_params(torch, dev, gen, D, occ, da, S)
                cot = chip_smoke.bwd_cotangents(torch, params, rays, z, tgt, ncfg, da, True)
                exact = bias_grad(F.render_rays_fused_bwd_plain(params, rays, z, *cot, ncfg, da,
                                                                dtype=torch.float64), ncfg)
                tol = 5e-3 * float(exact.abs().max())
                shares = {}
                for what, out in (("kernel", F._render_bwd_cuda(params, rays, z, *cot, ncfg, da)),
                                  ("f32", F.render_rays_fused_bwd_plain(params, rays, z, *cot,
                                                                        ncfg, da))):
                    shares[what] = float((bias_grad(out, ncfg) - exact).abs().max()) / tol
                # each ray alone, kernel against f64: the ray and column that move most
                worst = (0.0, 0, 0, 0.0)
                for i in range(n):
                    c = tuple(None if t is None else t[i:i + 1].contiguous() for t in cot)
                    k = bias_grad(F._render_bwd_cuda(params, rays[i:i + 1], z[i:i + 1], *c,
                                                     ncfg, da), ncfg)
                    e = bias_grad(F.render_rays_fused_bwd_plain(
                        params, rays[i:i + 1], z[i:i + 1], *c, ncfg, da, dtype=torch.float64),
                        ncfg)
                    j = int((k - e).abs().argmax())
                    if abs(float(k[j] - e[j])) > abs(worst[0]):
                        worst = (float(k[j] - e[j]), i, j, float(e[j]))
                delta, r, j, _ = worst
                # that ray's f64 forward and its rgb-hidden cotangent before the mask
                W, B = F.pack_weights(params, ncfg)
                Wf = [w.double() for w in W]
                rr, zz = rays[r:r + 1], z[r:r + 1]
                fwd = F._plain_forward(Wf, B, rr, zz, ncfg, da, torch.float64)
                taps = {}
                F._plain_backward_tail(Wf, rr.double(), zz.double(), fwd, ncfg, da,
                                       *(None if t is None else t[r:r + 1].double()
                                         for t in cot), False, taps)
                g = (taps["g_rgb"] @ Wf[13][:3])[:, j]               # (S,) g_h unmasked
                s = int((g.abs() - abs(delta)).abs().argmin())
                feat = fwd["acts"][8][s]
                de_h = fwd["de"][0] @ Wf[12][j]
                pre = float(feat @ Wf[11][j] + de_h + B[10][j].double())
                scale = float(feat.abs() @ Wf[11][j].abs() + de_h.abs() + B[10][j].abs())
                print(f"attribution D={D} {n} rays x {S} occ={occ} dist_alpha={da} seed {seed}: "
                      f"{blk} kernel~f64 {shares['kernel']:.3f}, f32~f64 {shares['f32']:.3f} of "
                      f"the rule; the ray moving it most alone: ray {r}, column {j}, kernel - "
                      f"f64 {delta / tol:.3f} of the rule = {delta / float(g[s]):.4f} x the "
                      f"unmasked g_h of its sample {s} (weight {float(fwd['weights'][0, s]):.4f}"
                      f"); that sample's f64 pre-activation {pre:.3e}, "
                      f"{abs(pre) / (scale * 2.0 ** -24):.1f} f32 half-ulps of the sum of its "
                      f"terms' magnitudes {scale:.3e}", flush=True)
                torch.cuda.empty_cache()


def tensor_core_products(torch, chip_smoke, dev) -> None:
    """Part 2 of --frozen: the chain's own products by the tensor cores (the
    dW kernel, one accumulator chain over K), by cuBLAS in f32 and in f64."""
    from nope_nerf_torch.models.nerf import bf16_round
    from nope_nerf_torch.ops.fused_mlp import dw_sm90, tile_operand
    from nope_nerf_torch.ops.fused_render import pack_weights, render_dw_operands
    torch.backends.cuda.matmul.allow_tf32 = False

    def on_tensor_cores(a, b):
        """a (T, K) @ b (K, N) by dw_sm90: X = a^T, G = b in blocks of 256 columns."""
        T, K = a.shape
        x = tile_operand(a.t().contiguous())
        cols = [(c, min(c + 256, b.shape[1])) for c in range(0, b.shape[1], 256)]
        gs = [tile_operand(b[:, c0:c1].contiguous()) for c0, c1 in cols]
        return torch.cat(dw_sm90([x] * len(gs), gs, [T] * len(gs), K, 1), dim=1)

    def ulps(v, exact):
        """v - exact in ulps of the f32 exact value (f64)."""
        _, e = torch.frexp(exact.float())
        return (v.double() - exact) / torch.ldexp(torch.ones_like(exact), e.double() - 24)

    for D in FROZEN_WIDTHS:
        gen = torch.Generator().manual_seed(200 + D)
        rays, z, tgt = chip_smoke.train_inputs(torch, dev, gen, 8, SAMPLES)
        ncfg, params = chip_smoke.many_params(torch, dev, gen, D, "relu", True, SAMPLES)
        cot = chip_smoke.bwd_cotangents(torch, params, rays, z, tgt, ncfg, True, True)
        X, G, _ = render_dw_operands(params, rays, z, *cot, ncfg, True)
        W, B = pack_weights(params, ncfg)
        Wf = [w.float() for w in W]
        # forward: x_(i-1) -> x_i by (out, in) weight i, bias i; dX: g_l -> g_(l-1) by Wf[wi]
        fwd = [(X[f"x{i - 1}"], Wf[i].t(), B[i]) for i in (1, 2, 3)]
        fwd += [(X[f"x{i - 2}"], Wf[i].t(), B[i - 1]) for i in (6, 7, 8)]
        bwd = [(G[f"g{wi - 1}"], Wf[wi]) for wi in (8, 7, 6)]
        bwd += [(G[f"g{wi}"], Wf[wi]) for wi in (4, 3, 2, 1)]
        stats = {"tensor cores": [0.0, 0.0, 0, 0], "cuBLAS f32": [0.0, 0.0, 0, 0]}
        entries = masks = flips_tc = flips_f32 = 0
        for a, b, *bias in fwd + bwd:
            exact = a.double() @ b.double()
            got = {"tensor cores": on_tensor_cores(a, b), "cuBLAS f32": a @ b}
            ref_bf = exact.to(torch.bfloat16)
            towards = -torch.sign(exact)
            for name, v in got.items():
                u = ulps(v, exact)
                st = stats[name]
                st[0] += float(u.abs().sum())
                st[1] += float((u * towards).sum())
                st[2] += int((v.to(torch.bfloat16) != ref_bf).sum())
            entries += exact.numel()
            if bias:
                pre = exact + bias[0].double()
                masks += pre.numel()
                flips_tc += int(((got["tensor cores"] + bias[0]) > 0).ne(pre > 0).sum())
                flips_f32 += int(((got["cuBLAS f32"] + bias[0]) > 0).ne(pre > 0).sum())
        print(f"products D={D} (K = {D}; {len(fwd)} forward and {len(bwd)} dX products over "
              f"{a.shape[0]} points, {entries} entries): "
              + "; ".join(f"{name} mean |error| {st[0] / entries:.3f} ulp, towards zero "
                          f"{st[1] / entries:+.3f} ulp, bf16 rounding differs from the exact "
                          f"value's in {st[2]} ({st[2] / entries:.2e})"
                          for name, st in stats.items())
              + f"; pre-activation signs differing from the exact ones: tensor cores "
              f"{flips_tc}, cuBLAS f32 {flips_f32} of {masks}", flush=True)


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frozen", action="store_true",
                    help="the frozen-network variant at every width (see the module text)")
    ap.add_argument("--full", action="store_true",
                    help="K6 full at 384 and 512 and small point counts, or the numerics rule "
                         "past 512 (see the module text)")
    ap.add_argument("--render-full", action="store_true",
                    help="K1 and K4 full at every width on phase 13's cases (see the module "
                         "text)")
    ap.add_argument("--forward", action="store_true",
                    help="K3 and K5 against the f64 forward at every width (see the module "
                         "text)")
    ap.add_argument("--cases", nargs="+", default=None, metavar="RAYSxS",
                    help="with --render-full: these cases instead of phase 13's, and no part 2")
    ap.add_argument("--widths", type=int, nargs="+", default=None,
                    help="with --render-full or --forward (default 128 to 512) or --full "
                         "(default 384 and 512): the widths; with --frozen, part 1 alone at "
                         "these widths on 1024 rays")
    ap.add_argument("--seeds", type=int, default=RENDER_FULL_SEEDS,
                    help="with --render-full: seeds a case")
    ap.add_argument("--attribute", action="store_true",
                    help="with --render-full and --cases: K4 full's rgb-hidden bias gradient "
                         "against f64 ray by ray on the relu / dist_alpha flag set (see the "
                         "module text)")
    ap.add_argument("--flag-set", type=int, choices=(0, 1), default=None,
                    help="with --render-full: one flag set of WIDE_FLAGS (0 softplus, 1 relu "
                         "with dist_alpha) instead of both")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("backward_noise: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())   # chip_smoke.py sits at the root of the checkout
    import chip_smoke
    if args.frozen or args.full or args.render_full or args.forward:
        import subprocess
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
        from nope_nerf_torch.ops import fused_mlp, fused_render
        from nope_nerf_torch.ops._build import build_all
        dev = torch.device("cuda")
        if args.forward:
            build_all((fused_render.RENDER_FWD, fused_mlp.POINT_MLP_FWD))
            forward_flips(torch, chip_smoke, dev, args.widths or FROZEN_WIDTHS)
            return 0
        if args.full:
            build_all((fused_mlp.POINT_MLP_BWD, fused_mlp.POINT_MLP_BWD_XWIDE))
            widths = args.widths or chip_smoke.WIDE_D
            if any(D <= 512 for D in widths):
                full_yardstick(torch, chip_smoke, dev, [D for D in widths if D <= 512])
            if any(D > 512 for D in widths):
                full_rule(torch, chip_smoke, dev, [D for D in widths if D > 512])
            return 0
        if args.render_full:
            widths = args.widths or list(FROZEN_WIDTHS)
            build_all((fused_render.RENDER_TRAIN, fused_render.RENDER_BWD)
                      + ((fused_render.RENDER_TRAIN_XWIDE, fused_render.RENDER_BWD_XWIDE)
                         if any(D > 512 for D in widths) else ()))
            cases = None if args.cases is None else [
                tuple(int(v) for v in c.split("x")) for c in args.cases]
            if args.attribute:
                render_full_attribution(torch, chip_smoke, dev, widths,
                                        cases or chip_smoke.WIDE_RENDER_CASES, args.seeds)
                return 0
            flags = None if args.flag_set is None else (args.flag_set,)
            if cases is not None:
                render_full_yardstick(torch, chip_smoke, dev, widths, cases, args.seeds, flags)
                return 0
            classes = [D for D in widths if D <= 512]   # the yardstick's widths
            if classes:
                render_full_yardstick(torch, chip_smoke, dev, classes, None, args.seeds, flags)
                render_full_flips(torch, chip_smoke, dev, classes)
            render_full_rule(torch, chip_smoke, dev, widths)
            return 0
        if args.widths:
            build_all((fused_render.RENDER_BWD_FROZEN,))
            frozen_yardstick(torch, chip_smoke, dev, args.widths, (chip_smoke.WIDE_BWD_RAYS,))
            return 0
        build_all((fused_render.RENDER_BWD_FROZEN, fused_mlp.DW_SM90))
        tensor_core_products(torch, chip_smoke, dev)
        frozen_yardstick(torch, chip_smoke, dev)
        return 0
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
