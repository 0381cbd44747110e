"""The port's DPT-Hybrid (nope_nerf_torch/models/dpt.py), its weight
converters (convert.py) and input transform (data/dpt_transforms.py,
data/image_io.py::resize_cubic) against the JAX package on the CPU.

The JAX package works NHWC with HWIO convs and (in, out) linears, the port
NCHW with OIHW and (out, in): inputs are transposed on the way. Primitives
agree within 1e-5 of the largest magnitude of the JAX result, the forward of
the small configuration of tests/test_dpt.py within 1e-4; the random init is
bit-equal; resize_cubic is within 1e-5 of cv2's INTER_CUBIC on float32.
"""

import dataclasses

import cv2
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import jax
import jax.numpy as jnp

from nope_nerf_tpu.data import dpt_transforms as jtf
from nope_nerf_tpu.models import dpt as J

from nope_nerf_torch.convert import dpt_params_from_jax, dpt_params_to_jax
from nope_nerf_torch.data import dpt_transforms as ttf
from nope_nerf_torch.data.image_io import resize_cubic
from nope_nerf_torch.models import dpt as T

torch.set_num_threads(2)

SMALL = dict(features=32, vit_dim=64, vit_heads=4, vit_blocks=2, resnet_layers=(1, 1, 1),
             hooks=(0, 1), patch_grid=4)        # tests/test_dpt.py's dpt_small


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, top = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * top, (err, top)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))


# ---- primitives --------------------------------------------------------------------

@pytest.mark.parametrize("k,stride,h,w", [(7, 2, 15, 15), (3, 1, 9, 11), (3, 2, 10, 13),
                                          (1, 2, 8, 9)])
def test_std_conv_same(k, stride, h, w):
    rng = np.random.RandomState(k + stride)
    x = rng.randn(1, h, w, 5).astype(np.float32)
    wt = rng.randn(k, k, 5, 8).astype(np.float32)
    want = J.std_conv(jnp.asarray(x), jnp.asarray(wt), None, stride)
    got = nhwc(T.std_conv(nchw(x), oihw(wt), None, stride))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("act", [False, True])
def test_group_norm(act):
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 5, 7, 64) * 3 + 1).astype(np.float32)
    g, b = rng.rand(64).astype(np.float32), rng.randn(64).astype(np.float32)
    want = J.group_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), act=act)
    got = nhwc(T.group_norm(nchw(x), torch.from_numpy(g), torch.from_numpy(b), act=act))
    _close(got, want, 1e-5)


def test_layer_norm():
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 9, 48) * 2 - 1).astype(np.float32)
    g, b = rng.rand(48).astype(np.float32), rng.randn(48).astype(np.float32)
    want = J.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    got = T.layer_norm(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b))
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("h,w", [(9, 11), (8, 8), (7, 10)])
def test_max_pool_same_pads_with_minus_infinity(h, w):
    # all-negative inputs: a zero padding would win the max at the border
    x = -np.random.RandomState(4).rand(1, h, w, 4).astype(np.float32) - 1
    want = J.max_pool_same(jnp.asarray(x), 3, 2)
    got = nhwc(T.max_pool_same(nchw(x), 3, 2))
    _close(got, want, 1e-5)
    assert np.all(got < -1)


@pytest.mark.parametrize("size_in,size_out", [((5, 7), (10, 14)), ((12, 40), (24, 80)),
                                              ((6, 4), (9, 11)), ((1, 3), (2, 6))])
def test_resize_bilinear_align_corners(size_in, size_out):
    x = np.random.RandomState(5).randn(1, *size_in, 6).astype(np.float32)
    want = J.resize_bilinear_ac(jnp.asarray(x), size_out)
    got = nhwc(T.resize_bilinear_ac(nchw(x), size_out))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("size_out", [(3, 7), (24, 80), (4, 4)])
def test_resize_bilinear_half_pixel(size_out):
    x = np.random.RandomState(6).randn(1, 4, 4, 6).astype(np.float32)
    want = J.resize_bilinear_nac(jnp.asarray(x), size_out)
    got = T.resize_bilinear_nac(torch.from_numpy(x[0]), size_out)
    _close(got.numpy()[None], want, 1e-5)


@pytest.mark.parametrize("gs", [(12, 18), (24, 80)])
def test_resize_pos_embed(gs):
    pos = np.random.RandomState(7).randn(1, 24 * 24 + 1, 16).astype(np.float32)
    want = J._resize_pos_embed(jnp.asarray(pos), *gs)
    got = T.resize_pos_embed(torch.from_numpy(pos), *gs)
    _close(got.numpy(), want, 1e-5)
    np.testing.assert_array_equal(got.numpy()[:, 0], pos[:, 0])


def test_attention():
    rng = np.random.RandomState(8)
    d, heads = 64, 4
    x = rng.randn(2, 10, d).astype(np.float32)
    p = {"b.attn.qkv.weight": rng.randn(d, 3 * d).astype(np.float32) * 0.2,
         "b.attn.qkv.bias": rng.randn(3 * d).astype(np.float32) * 0.1,
         "b.attn.proj.weight": rng.randn(d, d).astype(np.float32) * 0.2,
         "b.attn.proj.bias": rng.randn(d).astype(np.float32) * 0.1}
    want = J._attention({k: jnp.asarray(v) for k, v in p.items()}, "b", jnp.asarray(x), heads)
    t = {k: torch.from_numpy(np.ascontiguousarray(v.T if v.ndim == 2 else v))
         for k, v in p.items()}
    got = T.attention(torch.from_numpy(x), t["b.attn.qkv.weight"], t["b.attn.qkv.bias"],
                      t["b.attn.proj.weight"], t["b.attn.proj.bias"], heads)
    _close(got.numpy(), want, 1e-5)


# ---- parameters -------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    jcfg, tcfg = J.DPTConfig(**SMALL), T.DPTConfig(**SMALL)
    jparams = J.init_dpt_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jparams, T.make_dpt(T.init_dpt_params(tcfg), tcfg, "cpu")


def test_random_init_is_bit_equal_to_jax(small):
    jcfg, tcfg, jparams, model = small
    ours = T.init_dpt_params(tcfg)
    theirs = dpt_params_from_jax({k: np.asarray(v) for k, v in jparams.items()})
    assert set(ours) == set(theirs) == set(model.state_dict())
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
        assert torch.equal(model.state_dict()[k], ours[k]), k
    back = dpt_params_to_jax(ours)
    for k, v in jparams.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


def test_full_config_inventory_matches_jax():
    """The default DPTConfig's parameters (the MiDaS dpt_hybrid set, ~123M):
    keys and shapes only, no forward."""
    jparams = J.init_dpt_params(jax.random.key(0))
    model = T.DPT(T.DPTConfig(), device="meta")
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = {k: tuple(v.shape) for k, v in dpt_params_from_jax(
        {k: np.empty(v.shape, np.float32) for k, v in jparams.items()}).items()}
    assert shapes == want
    assert 110e6 < sum(int(np.prod(s)) for s in shapes.values()) < 130e6


# ---- the forward ------------------------------------------------------------------

@pytest.mark.parametrize("invert", [True, False])
def test_forward_matches_jax(small, invert):
    jcfg, tcfg, jparams, model = small
    jcfg = dataclasses.replace(jcfg, invert=invert)
    img = np.random.RandomState(8).randn(1, 64, 96, 3).astype(np.float32)
    want = jax.jit(lambda p, x: J.dpt_apply(p, x, jcfg))(jparams, jnp.asarray(img))
    model.cfg = dataclasses.replace(tcfg, invert=invert)
    try:
        with torch.inference_mode():
            got = model(nchw(img))
    finally:
        model.cfg = tcfg
    assert got.shape == (1, 64, 96) and bool(torch.isfinite(got).all())
    _close(got.numpy(), want, 1e-4)


def test_stages_are_the_forward_and_flops_count_the_products(small):
    jcfg, tcfg, jparams, model = small
    img = nchw(np.random.RandomState(9).randn(1, 64, 96, 3).astype(np.float32))
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        st = model.stages(img)
    assert {k: tuple(v.shape) for k, v in st.items() if k[0] == "l"} == {
        "l1": (1, 256, 16, 24), "l2": (1, 512, 8, 12), "l3": (1, 64, 4, 6), "l4": (1, 64, 2, 3)}
    assert st["path1"].shape == (1, 32, 32, 48)
    with torch.inference_mode():
        assert torch.equal(model(img), st["depth"])
    # the counter also counts the two products of the position-embedding resize
    g, gh, gw, d = tcfg.patch_grid, 4, 6, tcfg.vit_dim
    resize = 2 * gh * g * g * d + 2 * gw * g * gh * d
    assert counter.get_total_flops() == sum(T.dpt_flops(tcfg, 64, 96).values()) + resize


@pytest.mark.parametrize("form", ["npz", "pt", "pt_wrapped"])
def test_load_dpt(tmp_path, small, form):
    jcfg, tcfg, jparams, model = small
    if form == "npz":
        path = tmp_path / "dpt.npz"
        np.savez(path, **{k: np.asarray(v) for k, v in jparams.items()})
    else:
        sd = T.init_dpt_params(tcfg)
        # the MiDaS file also holds the final ViT norm, which the forward never reads
        sd["pretrained.model.norm.weight"] = torch.ones(tcfg.vit_dim)
        sd["pretrained.model.norm.bias"] = torch.zeros(tcfg.vit_dim)
        path = tmp_path / "dpt.pt"
        torch.save({"state_dict": sd} if form == "pt_wrapped" else sd, path)
    loaded, cfg = T.load_dpt(str(path), tcfg, device="cpu")
    assert cfg == tcfg
    ref = model.state_dict()
    assert set(loaded.state_dict()) == set(ref)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, ref[k]), k


def test_load_dpt_refuses_missing_keys(tmp_path, small):
    jcfg, tcfg, jparams, model = small
    sd = T.init_dpt_params(tcfg)
    del sd["scratch.output_conv.4.weight"]
    torch.save(sd, tmp_path / "dpt.pt")
    with pytest.raises(KeyError, match="miss 1 keys"):
        T.load_dpt(str(tmp_path / "dpt.pt"), tcfg, device="cpu")


# ---- the input transform ------------------------------------------------------------

@pytest.mark.parametrize("size_in,size_out", [
    ((188, 621), (384, 1280)), ((756, 1008), (384, 512)), ((100, 150), (384, 576)),
    ((37, 53), (20, 31)), ((5, 7), (13, 3)), ((3, 2), (17, 9))])
def test_resize_cubic_matches_cv2(size_in, size_out):
    img = np.random.RandomState(10).rand(*size_in, 3).astype(np.float32)
    want = cv2.resize(img, size_out[::-1], interpolation=cv2.INTER_CUBIC)
    got = resize_cubic(img, size_out)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    gray = img[..., 0].copy()
    np.testing.assert_allclose(resize_cubic(gray, size_out),
                               cv2.resize(gray, size_out[::-1], interpolation=cv2.INTER_CUBIC),
                               rtol=0, atol=1e-5)


SIZES = [(188, 621), (375, 1242), (756, 1008), (540, 960), (384, 384), (480, 640), (100, 150),
         (32, 48), (1000, 300), (383, 385)]


def test_dpt_target_size_matches_jax():
    for h, w in SIZES:
        assert ttf.dpt_target_size(h, w) == jtf.dpt_target_size(h, w), (h, w)
    assert ttf.dpt_target_size(188, 621) == (384, 1280)
    assert ttf.dpt_target_size(756, 1008) == (384, 512)


@pytest.mark.parametrize("h,w", [(188, 621), (100, 150), (32, 48), (383, 385)])
def test_prepare_dpt_input_matches_jax(h, w):
    img = np.random.RandomState(h).rand(h, w, 3).astype(np.float32)
    got, want = ttf.prepare_dpt_input(img), jtf.prepare_dpt_input(img)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
