"""DPT-Hybrid monocular depth estimator in PyTorch (the frozen depth prior).

Port of nope_nerf_tpu/models/dpt.py (reference DPT/dpt/models.py:93-212
DPT/DPTDepthModel, DPT/dpt/vit.py's hybrid backbone, DPT/dpt/blocks.py's
RefineNet fusion), NCHW:

- backbone: timm `vit_base_resnet50_384`, a ResNetV2 stem (weight-standardised
  TF-'SAME' convs, GroupNorm(32), non-preactivation bottlenecks, stages
  (3, 4, 9)) feeding a ViT-Base/16 (12 blocks, 12 heads, learned cls token,
  bilinear-resized position embeddings);
- taps: ResNet stage 0 (/4, 256 channels) and stage 1 (/8, 512), transformer
  blocks 8 and 11 without the final norm, the token maps through the
  'project' readout (cls token concatenated after the spatial tokens, Linear,
  exact GELU) and 1x1 / strided 3x3 convs;
- decoder: per-scale 3x3 convs to 256 channels, four fusion blocks (residual
  conv units, x2 bilinear upsampling with align_corners, 1x1 out conv) and the
  monocular head; depth = 1 / max(scale * x + shift, 1e-8).

`DPT` is an nn.Module whose state_dict keys are the MiDaS
`dpt_hybrid-midas-501f0c75.pt` keys the JAX package keeps, in torch layouts
(conv OIHW, linear (out, in)), so such a checkpoint loads with
load_state_dict. No Pallas kernel is involved in the JAX package: its convs
are lax.conv_general_dilated and its products plain `@`. Here they are
F.conv2d, F.linear, matmul and softmax in float32 (the package turns TF32
off); attention stays an explicit matmul and softmax, as in JAX, and not
scaled_dot_product_attention, whose backend choice would change the order of
the sums. Everything is frozen: the module's parameters take no gradient.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import DeviceLike, resolve_device
from ..ops.interp import _bilinear_weight


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    features: int = 256
    vit_dim: int = 768
    vit_heads: int = 12
    vit_blocks: int = 12
    mlp_ratio: int = 4
    resnet_layers: Tuple[int, int, int] = (3, 4, 9)
    hooks: Tuple[int, int] = (8, 11)        # transformer taps
    patch_grid: int = 24                    # 384 / 16
    non_negative: bool = True
    scale: float = 0.000305
    shift: float = 0.1378
    invert: bool = True

    @classmethod
    def from_cfg(cls, cfg: dict) -> "DPTConfig":
        d = cfg["depth"]
        return cls(non_negative=d["non_negative"], scale=d["scale"],
                   shift=d["shift"], invert=d["invert"])


RESNET_CHANNELS = ((64, 256), (256, 512), (512, 1024))   # (in, out) of each stage
BACKBONE = "pretrained.model.patch_embed.backbone"


# ---------------------------------------------------------------- primitives

def _same_pad(x: torch.Tensor, kh: int, kw: int, sh: int, sw: int,
              value: float = 0.0) -> torch.Tensor:
    """TF-'SAME' asymmetric padding (timm StdConv2dSame / MaxPool2dSame): the
    odd pixel goes to the bottom and the right."""
    h, w = x.shape[-2:]
    pad_h = max((math.ceil(h / sh) - 1) * sh + kh - h, 0)
    pad_w = max((math.ceil(w / sw) - 1) * sw + kw - w, 0)
    return F.pad(x, (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2),
                 value=value)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding="SAME_TF") -> torch.Tensor:
    """NCHW conv with OIHW weights. padding: an int (symmetric), 'SAME_TF'
    (asymmetric) or 'VALID'."""
    if padding == "SAME_TF":
        x = _same_pad(x, w.shape[2], w.shape[3], stride, stride)
        padding = 0
    elif padding == "VALID":
        padding = 0
    return F.conv2d(x, w, b, stride, padding)


def std_conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], stride: int,
             padding="SAME_TF", eps: float = 1e-8) -> torch.Tensor:
    """Weight-standardised conv (timm StdConv2dSame): each output channel's
    weights to zero mean and unit (biased) variance."""
    var, mean = torch.var_mean(w, dim=(1, 2, 3), correction=0, keepdim=True)
    return conv2d(x, (w - mean) / torch.sqrt(var + eps), b, stride, padding)


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               groups: int = 32, eps: float = 1e-5, act: bool = True) -> torch.Tensor:
    out = F.group_norm(x, groups, gamma, beta, eps)
    return F.relu(out) if act else out


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], gamma, beta, eps)


def max_pool_same(x: torch.Tensor, k: int = 3, stride: int = 2) -> torch.Tensor:
    """Max pool with TF-'SAME' padding: F.max_pool2d pads symmetrically only,
    so the -inf border (which the max ignores) goes on first."""
    return F.max_pool2d(_same_pad(x, k, k, stride, stride, value=-math.inf), k, stride)


def resize_bilinear_ac(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with align_corners=True (the decoder's x2 upsampling)."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=True)


def resize_bilinear_nac(grid: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(H, W, C) -> (size[0], size[1], C), bilinear with align_corners=False, as
    two products with ops/interp.py's weight matrices (as the JAX package
    resizes the position embeddings)."""
    def weight(n_out, n_in):
        return torch.from_numpy(_bilinear_weight(n_out, n_in)).to(grid.device)
    x = torch.einsum("oh,hwc->owc", weight(size[0], grid.shape[0]), grid)
    return torch.einsum("ow,hwc->hoc", weight(size[1], grid.shape[1]), x)


def attention(x: torch.Tensor, qkv_w: torch.Tensor, qkv_b: torch.Tensor,
              proj_w: torch.Tensor, proj_b: torch.Tensor, heads: int) -> torch.Tensor:
    """Multi-head self-attention over (B, N, D) tokens; qkv splits as (3, heads,
    dh), as timm's Attention."""
    b, n, d = x.shape
    qkv = F.linear(x, qkv_w, qkv_b).reshape(b, n, 3, heads, d // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)                   # (B, H, N, dh) each
    att = torch.softmax((q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(d // heads)), dim=-1)
    y = (att @ v).transpose(1, 2).reshape(b, n, d)
    return F.linear(y, proj_w, proj_b)


def resize_pos_embed(pos: torch.Tensor, gs_h: int, gs_w: int) -> torch.Tensor:
    """vit.py:148-163: keep the cls token, bilinear-resize the grid part."""
    tok, grid = pos[:, :1], pos[0, 1:]
    gs_old = int(math.sqrt(grid.shape[0]))
    grid = resize_bilinear_nac(grid.reshape(gs_old, gs_old, -1), (gs_h, gs_w))
    return torch.cat([tok, grid.reshape(1, gs_h * gs_w, -1)], dim=1)


# ---------------------------------------------------------------- parameters

def _spec(cfg: DPTConfig) -> Iterator[Tuple[str, str, Tuple[int, ...]]]:
    """(name, kind, shape) of every parameter, in the order the JAX package's
    init_dpt_params draws them. kind: 'conv' (drawn HWIO), 'linear' (drawn
    (in, out)), 'pos' (drawn as is), 'zeros', 'ones'."""
    def conv(name, kh, kw, cin, cout, bias=True):
        yield name + ".weight", "conv", (kh, kw, cin, cout)
        if bias:
            yield name + ".bias", "zeros", (cout,)

    def norm(name, c):
        yield name + ".weight", "ones", (c,)
        yield name + ".bias", "zeros", (c,)

    def linear(name, cin, cout):
        yield name + ".weight", "linear", (cin, cout)
        yield name + ".bias", "zeros", (cout,)

    bb = BACKBONE
    yield from conv(f"{bb}.stem.conv", 7, 7, 3, 64, bias=False)
    yield from norm(f"{bb}.stem.norm", 64)
    for si, n_blocks in enumerate(cfg.resnet_layers):
        cin, cout = RESNET_CHANNELS[si]
        mid = cout // 4
        for bi in range(n_blocks):
            pre = f"{bb}.stages.{si}.blocks.{bi}"
            cin_b = cin if bi == 0 else cout
            if bi == 0:
                yield from conv(f"{pre}.downsample.conv", 1, 1, cin_b, cout, bias=False)
                yield from norm(f"{pre}.downsample.norm", cout)
            yield from conv(f"{pre}.conv1", 1, 1, cin_b, mid, bias=False)
            yield from norm(f"{pre}.norm1", mid)
            yield from conv(f"{pre}.conv2", 3, 3, mid, mid, bias=False)
            yield from norm(f"{pre}.norm2", mid)
            yield from conv(f"{pre}.conv3", 1, 1, mid, cout, bias=False)
            yield from norm(f"{pre}.norm3", cout)

    pm, d = "pretrained.model", cfg.vit_dim
    yield from conv(f"{pm}.patch_embed.proj", 1, 1, RESNET_CHANNELS[2][1], d)
    yield f"{pm}.cls_token", "zeros", (1, 1, d)
    yield f"{pm}.pos_embed", "pos", (1, cfg.patch_grid ** 2 + 1, d)
    for i in range(cfg.vit_blocks):
        pre = f"{pm}.blocks.{i}"
        yield from norm(f"{pre}.norm1", d)
        yield from linear(f"{pre}.attn.qkv", d, 3 * d)
        yield from linear(f"{pre}.attn.proj", d, d)
        yield from norm(f"{pre}.norm2", d)
        yield from linear(f"{pre}.mlp.fc1", d, cfg.mlp_ratio * d)
        yield from linear(f"{pre}.mlp.fc2", cfg.mlp_ratio * d, d)

    for idx in (3, 4):
        yield from linear(f"pretrained.act_postprocess{idx}.0.project.0", 2 * d, d)
    yield from conv("pretrained.act_postprocess3.3", 1, 1, d, d)
    yield from conv("pretrained.act_postprocess4.3", 1, 1, d, d)
    yield from conv("pretrained.act_postprocess4.4", 3, 3, d, d)

    f = cfg.features
    for i, cin in ((1, RESNET_CHANNELS[0][1]), (2, RESNET_CHANNELS[1][1]), (3, d), (4, d)):
        yield from conv(f"scratch.layer{i}_rn", 3, 3, cin, f, bias=False)
    for i in (1, 2, 3, 4):
        pre = f"scratch.refinenet{i}"
        yield from conv(f"{pre}.out_conv", 1, 1, f, f)
        for r in (1, 2):
            yield from conv(f"{pre}.resConfUnit{r}.conv1", 3, 3, f, f)
            yield from conv(f"{pre}.resConfUnit{r}.conv2", 3, 3, f, f)
    yield from conv("scratch.output_conv.0", 3, 3, f, f // 2)
    yield from conv("scratch.output_conv.2", 3, 3, f // 2, 32)
    yield from conv("scratch.output_conv.4", 1, 1, 32, 1)


def _torch_layout(kind: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    if kind == "conv":
        kh, kw, cin, cout = shape
        return cout, cin, kh, kw
    if kind == "linear":
        return shape[1], shape[0]
    return shape


def init_dpt_params(cfg: Optional[DPTConfig] = None) -> Dict[str, torch.Tensor]:
    """Random DPT weights (tests and runs without the 470 MB checkpoint) as a
    state dict of CPU tensors: the JAX package's init_dpt_params draw for draw
    (numpy RandomState(0), N(0, 0.02) for convs, linears and the position
    embeddings, ones and zeros for norms and biases), in torch layouts."""
    cfg = cfg or DPTConfig()
    rng = np.random.RandomState(0)
    out: Dict[str, torch.Tensor] = {}
    for name, kind, shape in _spec(cfg):
        if kind in ("conv", "linear", "pos"):
            a = rng.randn(*shape).astype(np.float32) * 0.02
            if kind == "conv":
                a = a.transpose(3, 2, 0, 1)
            elif kind == "linear":
                a = a.T
        else:
            a = (np.ones if kind == "ones" else np.zeros)(shape, np.float32)
        out[name] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def _register(root: nn.Module, name: str, tensor: torch.Tensor) -> None:
    """Register `tensor` as the frozen parameter at dotted `name`, making the
    intermediate modules on the way."""
    *path, leaf = name.split(".")
    mod = root
    for part in path:
        child = mod._modules.get(part)
        if child is None:
            child = nn.Module()
            mod.add_module(part, child)
        mod = child
    mod.register_parameter(leaf, nn.Parameter(tensor, requires_grad=False))


# ---------------------------------------------------------------- the module

class DPT(nn.Module):
    """DPT-Hybrid over (B, 3, H, W) normalised images (H, W multiples of 32,
    as data/dpt_transforms.py makes them). Its parameters are uninitialised
    until a state dict is loaded (`make_dpt`)."""

    def __init__(self, cfg: Optional[DPTConfig] = None, device: DeviceLike = None):
        super().__init__()
        self.cfg = cfg or DPTConfig()
        dev = resolve_device(device)
        for name, kind, shape in _spec(self.cfg):
            _register(self, name, torch.empty(_torch_layout(kind, shape), device=dev))

    def _bottleneck(self, p, pre: str, x: torch.Tensor, stride: int, has_down: bool):
        """Non-preactivation ResNetV2 bottleneck (timm resnetv2.Bottleneck)."""
        sc = x
        if has_down:
            sc = std_conv(x, p[f"{pre}.downsample.conv.weight"], None, stride)
            sc = group_norm(sc, p[f"{pre}.downsample.norm.weight"],
                            p[f"{pre}.downsample.norm.bias"], act=False)
        y = std_conv(x, p[f"{pre}.conv1.weight"], None, 1)
        y = group_norm(y, p[f"{pre}.norm1.weight"], p[f"{pre}.norm1.bias"])
        y = std_conv(y, p[f"{pre}.conv2.weight"], None, stride)
        y = group_norm(y, p[f"{pre}.norm2.weight"], p[f"{pre}.norm2.bias"])
        y = std_conv(y, p[f"{pre}.conv3.weight"], None, 1)
        y = group_norm(y, p[f"{pre}.norm3.weight"], p[f"{pre}.norm3.bias"], act=False)
        return F.relu(y + sc)

    def _resnet(self, p, x: torch.Tensor):
        """Stem and three stages: the /4, /8 and /16 features."""
        x = std_conv(x, p[f"{BACKBONE}.stem.conv.weight"], None, 2)
        x = group_norm(x, p[f"{BACKBONE}.stem.norm.weight"], p[f"{BACKBONE}.stem.norm.bias"])
        x = max_pool_same(x, 3, 2)
        outs = []
        for si, n_blocks in enumerate(self.cfg.resnet_layers):
            for bi in range(n_blocks):
                x = self._bottleneck(p, f"{BACKBONE}.stages.{si}.blocks.{bi}", x,
                                     2 if (bi == 0 and si > 0) else 1, bi == 0)
            outs.append(x)
        return outs

    def _vit(self, p, feat16: torch.Tensor):
        """The hooked blocks' tokens, (B, 1 + N, D) each, without the final norm
        (vit.py:365-379)."""
        pm, cfg = "pretrained.model", self.cfg
        b, _, gh, gw = feat16.shape
        x = conv2d(feat16, p[f"{pm}.patch_embed.proj.weight"],
                   p[f"{pm}.patch_embed.proj.bias"], 1, "VALID")
        x = x.flatten(2).transpose(1, 2)                            # (B, gh*gw, D)
        x = torch.cat([p[f"{pm}.cls_token"].expand(b, 1, cfg.vit_dim), x], dim=1)
        x = x + resize_pos_embed(p[f"{pm}.pos_embed"], gh, gw)
        taps = {}
        for i in range(cfg.vit_blocks):
            pre = f"{pm}.blocks.{i}"
            h = layer_norm(x, p[f"{pre}.norm1.weight"], p[f"{pre}.norm1.bias"])
            x = x + attention(h, p[f"{pre}.attn.qkv.weight"], p[f"{pre}.attn.qkv.bias"],
                              p[f"{pre}.attn.proj.weight"], p[f"{pre}.attn.proj.bias"],
                              cfg.vit_heads)
            h = layer_norm(x, p[f"{pre}.norm2.weight"], p[f"{pre}.norm2.bias"])
            h = F.gelu(F.linear(h, p[f"{pre}.mlp.fc1.weight"], p[f"{pre}.mlp.fc1.bias"]))
            x = x + F.linear(h, p[f"{pre}.mlp.fc2.weight"], p[f"{pre}.mlp.fc2.bias"])
            if i in cfg.hooks:
                taps[i] = x
        return taps[cfg.hooks[0]], taps[cfg.hooks[1]]

    @staticmethod
    def _readout(p, idx: int, tokens: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
        """'project' readout: the spatial tokens, then the cls token beside each,
        Linear(2D -> D), exact GELU; back to (B, D, gh, gw)."""
        pre = f"pretrained.act_postprocess{idx}.0.project.0"
        spatial = tokens[:, 1:]
        feats = torch.cat([spatial, tokens[:, :1].expand_as(spatial)], dim=-1)
        y = F.gelu(F.linear(feats, p[f"{pre}.weight"], p[f"{pre}.bias"]))
        return y.transpose(1, 2).reshape(y.shape[0], -1, gh, gw)

    @staticmethod
    def _rcu(p, pre: str, x: torch.Tensor) -> torch.Tensor:
        """ResidualConvUnit_custom without batch norm (blocks.py:247-300)."""
        y = conv2d(F.relu(x), p[f"{pre}.conv1.weight"], p[f"{pre}.conv1.bias"], 1, 1)
        y = conv2d(F.relu(y), p[f"{pre}.conv2.weight"], p[f"{pre}.conv2.bias"], 1, 1)
        return y + x

    def _fusion(self, p, pre: str, x: torch.Tensor, skip: Optional[torch.Tensor]):
        """FeatureFusionBlock_custom (blocks.py:318-383)."""
        if skip is not None:
            x = x + self._rcu(p, f"{pre}.resConfUnit1", skip)
        x = self._rcu(p, f"{pre}.resConfUnit2", x)
        x = resize_bilinear_ac(x, (x.shape[2] * 2, x.shape[3] * 2))
        return conv2d(x, p[f"{pre}.out_conv.weight"], p[f"{pre}.out_conv.bias"], 1, 0)

    def stages(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Every stage's output on (B, 3, H, W): the decoder inputs l1 to l4,
        the last fusion block's path1, the inverse depth (B, H, W) and the
        depth 1 / max(scale * inv + shift, 1e-8)."""
        p = dict(self.named_parameters())
        b, _, h, w = img.shape
        gh, gw = h // 16, w // 16
        l1, l2, feat16 = self._resnet(p, img)                       # /4, /8, /16
        t3, t4 = self._vit(p, feat16)
        l3 = conv2d(self._readout(p, 3, t3, gh, gw), p["pretrained.act_postprocess3.3.weight"],
                    p["pretrained.act_postprocess3.3.bias"], 1, "VALID")
        l4 = conv2d(self._readout(p, 4, t4, gh, gw), p["pretrained.act_postprocess4.3.weight"],
                    p["pretrained.act_postprocess4.3.bias"], 1, "VALID")
        l4 = conv2d(l4, p["pretrained.act_postprocess4.4.weight"],
                    p["pretrained.act_postprocess4.4.bias"], 2, 1)     # /32

        rn = [conv2d(l, p[f"scratch.layer{i}_rn.weight"], None, 1, 1)
              for i, l in ((1, l1), (2, l2), (3, l3), (4, l4))]
        path = self._fusion(p, "scratch.refinenet4", rn[3], None)
        path = self._fusion(p, "scratch.refinenet3", path, rn[2])
        path = self._fusion(p, "scratch.refinenet2", path, rn[1])
        path1 = self._fusion(p, "scratch.refinenet1", path, rn[0])

        # the monocular head (models.py:170-180)
        y = conv2d(path1, p["scratch.output_conv.0.weight"], p["scratch.output_conv.0.bias"],
                   1, 1)
        y = resize_bilinear_ac(y, (y.shape[2] * 2, y.shape[3] * 2))
        y = F.relu(conv2d(y, p["scratch.output_conv.2.weight"],
                          p["scratch.output_conv.2.bias"], 1, 1))
        y = conv2d(y, p["scratch.output_conv.4.weight"], p["scratch.output_conv.4.bias"], 1, 0)
        if self.cfg.non_negative:
            y = F.relu(y)
        inv_depth = y[:, 0]
        depth = 1.0 / torch.clamp(self.cfg.scale * inv_depth + self.cfg.shift, min=1e-8)
        return {"l1": l1, "l2": l2, "l3": l3, "l4": l4, "path1": path1,
                "inv_depth": inv_depth, "depth": depth}

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, H, W): depth when cfg.invert (models.py:203-212),
        else the inverse depth."""
        out = self.stages(img)
        return out["depth"] if self.cfg.invert else out["inv_depth"]


def dpt_flops(cfg: DPTConfig, h: int, w: int) -> Dict[str, int]:
    """Multiply-add FLOPs (2 per product) of the convs and matmuls of one
    forward on an h x w input, by part: 'resnet', 'vit' (patch embedding,
    blocks), 'decoder' (readouts, the act_postprocess convs, the decoder and
    head). Norms, softmax and resizes are left out."""
    def conv(cin, cout, k, oh, ow):
        return 2 * cin * cout * k * k * oh * ow

    r, ho, wo = {}, h // 4, w // 4
    r["resnet"] = conv(3, 64, 7, h // 2, w // 2)
    for si, n_blocks in enumerate(cfg.resnet_layers):
        cin, cout = RESNET_CHANNELS[si]
        mid, hi, wi = cout // 4, ho, wo
        if si > 0:
            ho, wo = ho // 2, wo // 2
        for bi in range(n_blocks):
            c = cin if bi == 0 else cout
            r["resnet"] += (conv(c, mid, 1, hi if bi == 0 else ho, wi if bi == 0 else wo)
                            + conv(mid, mid, 3, ho, wo) + conv(mid, cout, 1, ho, wo)
                            + (conv(c, cout, 1, ho, wo) if bi == 0 else 0))
    gh, gw, d = h // 16, w // 16, cfg.vit_dim
    n = gh * gw + 1
    r["vit"] = conv(RESNET_CHANNELS[2][1], d, 1, gh, gw) + cfg.vit_blocks * (
        2 * n * d * (3 * d + d + 2 * cfg.mlp_ratio * d) + 4 * n * n * d)
    f = cfg.features
    dec = 2 * (2 * (n - 1) * 2 * d * d) + 2 * conv(d, d, 1, gh, gw) + conv(d, d, 3, gh // 2,
                                                                             gw // 2)
    sizes = {1: (h // 4, w // 4), 2: (h // 8, w // 8), 3: (gh, gw), 4: (h // 32, w // 32)}
    for i, cin in ((1, RESNET_CHANNELS[0][1]), (2, RESNET_CHANNELS[1][1]), (3, d), (4, d)):
        dec += conv(cin, f, 3, *sizes[i])
        n_rcu = 2 if i == 4 else 4
        dec += n_rcu * conv(f, f, 3, *sizes[i]) + conv(f, f, 1, 2 * sizes[i][0],
                                                       2 * sizes[i][1])
    dec += conv(f, f // 2, 3, h // 2, w // 2) + conv(f // 2, 32, 3, h, w) + conv(32, 1, 1, h, w)
    r["decoder"] = dec
    return r


def make_dpt(state_dict: Dict[str, torch.Tensor], cfg: Optional[DPTConfig] = None,
             device: DeviceLike = None) -> DPT:
    """A DPT on `device` holding `state_dict` (MiDaS keys, torch layouts). Keys
    the forward does not read (the checkpoint's final ViT norm, the classifier
    head) are ignored; a missing key raises."""
    model = DPT(cfg, device=device)
    missing, _ = model.load_state_dict(state_dict, strict=False)
    if missing:
        raise KeyError(f"DPT weights miss {len(missing)} keys, e.g. {missing[:3]}")
    return model.eval()


def load_dpt(path: str, cfg: Optional[DPTConfig] = None,
             device: DeviceLike = None) -> Tuple[DPT, DPTConfig]:
    """A DPT from a checkpoint: an .npz in the JAX package's layout (through
    convert.dpt_params_from_jax) or a torch .pt / .pth state dict, with or
    without a "state_dict" wrapper."""
    cfg = cfg or DPTConfig()
    if path.endswith(".npz"):
        from ..convert import dpt_params_from_jax
        with np.load(path) as data:
            sd = dpt_params_from_jax({k: data[k] for k in data.files})
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if "state_dict" in sd:
            sd = sd["state_dict"]
    return make_dpt(sd, cfg, device), cfg
