"""The port's RAFT (``models/raft.py``) and its loaders against the JAX
package's, on the CPU in fp32.

* RAFT ``.tiny()`` at 64x64: the JAX module's params (``cnet``'s folded
  batch-norm scale / bias drawn at random) carried into the torch module by
  ``flax_raft_to_state_dict``; the flows agree to 1e-4 absolute.
* Formula-verbatim oracles, written out here from princeton-vl /
  torchvision: the correlation window's channel order (the x offset slow,
  as ``tests/test_raft.py`` pins it for the JAX package) and torchvision's
  ``upsample_flow``. The port follows both. The JAX package's convex
  upsampling reads ``mask_conv2``'s channels neighbor-last: it equals the
  oracle only on a mask whose channels are permuted.
* Strict loads of synthetic princeton-vl (``module.`` prefixes, ``norm3``
  twins) and torchvision ``Raft_Large_Weights`` state dicts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import to_np
from univst_tpu.models import raft as jr
from univst_torch.models import convert as tcv
from univst_torch.models import raft as tr

PX = 64


@pytest.fixture(scope="module")
def tiny_pair():
    """(JAX params, JAX flow, images) for RAFT.tiny() at 64x64, the folded
    batch norms of ``cnet`` drawn at random."""
    cfg = jr.RAFTConfig.tiny()
    model = jr.RAFT(cfg)
    zero = jnp.zeros((1, PX, PX, 3), jnp.float32)
    params = to_np(jax.jit(model.init)(jax.random.PRNGKey(0), zero, zero)["params"])
    rng = np.random.default_rng(0)

    def perturb(node, in_cnet=False):
        for k, v in node.items():
            if isinstance(v, dict):
                perturb(v, in_cnet or k == "cnet")
            elif in_cnet and k in ("scale", "bias") and "kernel" not in node:
                node[k] = (rng.uniform(0.5, 1.5, v.shape) if k == "scale"
                           else rng.normal(0, 0.1, v.shape)).astype(np.float32)

    perturb(params)
    imgs = rng.uniform(0, 1, (2, 2, PX, PX, 3)).astype(np.float32)
    flow = np.asarray(jax.jit(model.apply)({"params": params}, imgs[0], imgs[1]))
    return cfg, params, imgs, flow


def _torch_raft(params):
    m = tr.RAFT(tr.RAFTConfig.tiny())
    m.load_state_dict(tcv.to_torch_state_dict(tcv.flax_raft_to_state_dict(params)),
                      strict=True)
    return m.eval()


def test_tiny_raft_matches_jax(tiny_pair):
    _, params, imgs, want = tiny_pair
    with torch.no_grad():
        got = _torch_raft(params)(*(torch.tensor(x).permute(0, 3, 1, 2) for x in imgs))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, PX, PX, 2)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_make_raft_flow_takes_frames_and_batches(tiny_pair):
    _, params, imgs, want = tiny_pair
    flow_fn = tr.make_raft_flow(_torch_raft(params))
    one = flow_fn(torch.tensor(imgs[0, 1]), torch.tensor(imgs[1, 1]))
    assert one.shape == (PX, PX, 2)
    np.testing.assert_allclose(one.numpy(), want[1], atol=1e-4, rtol=0)
    both = flow_fn(torch.tensor(imgs[0]), torch.tensor(imgs[1]))
    np.testing.assert_allclose(both.numpy(), want, atol=1e-4, rtol=0)


def test_corr_lookup_channel_order_matches_princeton():
    """Channel k = a*(2r+1) + b of the window samples corr at (x + off[a],
    y + off[b]): princeton-vl's CorrBlock adds the slow axis of
    ``meshgrid(dy, dx)`` ('ij') to x. Integer centers with a margin of r, so
    bilinear sampling is exact."""
    rng = np.random.default_rng(0)
    b, h, w, r = 1, 6, 7, 2
    n = b * h * w
    corr = rng.standard_normal((n, h, w)).astype(np.float32)
    cx = rng.integers(r, w - r, (b, h, w)).astype(np.float32)
    cy = rng.integers(r, h - r, (b, h, w)).astype(np.float32)
    coords = torch.tensor(np.stack([cx, cy], 1))
    got = tr._corr_lookup([torch.tensor(corr)[:, None]], coords, r)
    got = got.permute(0, 2, 3, 1).reshape(n, (2 * r + 1) ** 2).numpy()
    offs = np.arange(-r, r + 1)
    cxf, cyf = cx.reshape(n).astype(int), cy.reshape(n).astype(int)
    for a in range(2 * r + 1):       # x offset: the slow axis
        for bb in range(2 * r + 1):  # y offset: the fast axis
            want = corr[np.arange(n), cyf + offs[bb], cxf + offs[a]]
            np.testing.assert_allclose(got[:, a * (2 * r + 1) + bb], want, atol=1e-5)


def _torchvision_upsample_flow(flow, up_mask, factor: int = 8):
    """torchvision.models.optical_flow._utils.upsample_flow, verbatim."""
    batch_size, num_channels, h, w = flow.shape
    new_h, new_w = h * factor, w * factor
    up_mask = up_mask.view(batch_size, 1, 9, factor, factor, h, w)
    up_mask = torch.softmax(up_mask, dim=2)  # "convex" == weights sum to 1
    upsampled_flow = F.unfold(factor * flow, kernel_size=3, padding=1).view(
        batch_size, num_channels, 9, 1, 1, h, w)
    upsampled_flow = torch.sum(up_mask * upsampled_flow, dim=2)
    return upsampled_flow.permute(0, 1, 4, 2, 5, 3).reshape(batch_size, num_channels, new_h,
                                                           new_w)


def test_convex_upsample_is_torchvisions_and_the_jax_order_is_permuted():
    rng = np.random.default_rng(1)
    flow = rng.standard_normal((2, 2, 5, 6)).astype(np.float32)
    mask = rng.standard_normal((2, 576, 5, 6)).astype(np.float32)
    oracle = _torchvision_upsample_flow(torch.tensor(flow), torch.tensor(mask)).numpy()
    got = tr._convex_upsample(torch.tensor(flow), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, oracle, atol=1e-5)

    def jax_up(m):  # the JAX package's upsampling, NHWC in and out
        out = jr._convex_upsample(jnp.asarray(flow.transpose(0, 2, 3, 1)),
                                  jnp.asarray(m.transpose(0, 2, 3, 1)))
        return np.asarray(out).transpose(0, 3, 1, 2)

    # fed the checkpoint's mask, the JAX package mixes up the weights ...
    assert np.abs(jax_up(mask) - oracle).max() > 1e-2
    # ... and matches once channel (x*8 + y)*9 + n holds what torchvision
    # reads at n*64 + x*8 + y
    jax_order = mask.reshape(2, 9, 64, 5, 6).transpose(0, 2, 1, 3, 4).reshape(2, 576, 5, 6)
    np.testing.assert_allclose(jax_up(jax_order), oracle, atol=1e-5)
    np.testing.assert_array_equal(
        tcv._raft_mask_channels_to_torch(jax_order.transpose(1, 0, 2, 3)),
        mask.transpose(1, 0, 2, 3))


def _princeton_state_dict(cfg, rng):
    """A synthetic princeton-vl checkpoint for ``cfg``: DataParallel
    ``module.`` prefixes, and each strided block's downsampling batch norm
    under both names it is registered by (``norm3`` and ``downsample.1``)."""
    sd = {}

    def conv(name, cin, cout, k=3):
        kh, kw = (k, k) if isinstance(k, int) else k
        sd[name + ".weight"] = rng.standard_normal((cout, cin, kh, kw)).astype(np.float32)
        sd[name + ".bias"] = rng.standard_normal((cout,)).astype(np.float32)

    def bn(name, c):
        sd[name + ".weight"] = rng.uniform(0.5, 1.5, (c,)).astype(np.float32)
        sd[name + ".bias"] = rng.standard_normal((c,)).astype(np.float32)
        sd[name + ".running_mean"] = rng.standard_normal((c,)).astype(np.float32)
        sd[name + ".running_var"] = rng.uniform(0.5, 1.5, (c,)).astype(np.float32)
        sd[name + ".num_batches_tracked"] = np.asarray(7)

    d, hid, ctx = cfg.encoder_dims, cfg.hidden_dim, cfg.context_dim
    for enc, out, norm in (("fnet", cfg.encoder_out, "instance"), ("cnet", hid + ctx, "batch")):
        conv(f"{enc}.conv1", 3, d[0], 7)
        if norm == "batch":
            bn(f"{enc}.norm1", d[0])
        cin = d[0]
        for stage, ch in ((1, d[1]), (2, d[2]), (3, d[3])):
            for blk in (0, 1):
                s = f"{enc}.layer{stage}.{blk}"
                conv(s + ".conv1", cin if blk == 0 else ch, ch)
                conv(s + ".conv2", ch, ch)
                if norm == "batch":
                    bn(s + ".norm1", ch)
                    bn(s + ".norm2", ch)
                if blk == 0 and stage > 1:
                    conv(s + ".downsample.0", cin, ch, 1)
                    if norm == "batch":
                        bn(s + ".downsample.1", ch)
                        for leaf in ("weight", "bias", "running_mean", "running_var",
                                     "num_batches_tracked"):
                            sd[f"{s}.norm3.{leaf}"] = sd[f"{s}.downsample.1.{leaf}"]
                cin = ch
        conv(f"{enc}.conv2", d[3], out, 1)
    corr_ch = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
    for name, cin, cout, k in (("convc1", corr_ch, 256, 1), ("convc2", 256, 192, 3),
                               ("convf1", 2, 128, 7), ("convf2", 128, 64, 3),
                               ("conv", 256, 126, 3)):
        conv(f"update_block.encoder.{name}", cin, cout, k)
    for name in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2"):
        conv(f"update_block.gru.{name}", hid + ctx + 128, hid,
             (1, 5) if name.endswith("1") else (5, 1))
    conv("update_block.flow_head.conv1", hid, 256)
    conv("update_block.flow_head.conv2", 256, 2)
    conv("update_block.mask.0", hid, 256)
    conv("update_block.mask.2", 256, 64 * 9, 1)
    return {"module." + k: v for k, v in sd.items()}


def _to_torchvision(sd):
    """princeton-vl names -> torchvision ``Raft_Large_Weights`` names (the
    inverse of the loader's rename; princeton's ``norm3`` twins dropped)."""
    out = {}
    for k, v in sd.items():
        k = k[len("module."):]
        if ".norm3." in k:
            continue
        for a, b in (("update_block.encoder.convc1", "update_block.motion_encoder.convcorr1.0"),
                     ("update_block.encoder.convc2", "update_block.motion_encoder.convcorr2.0"),
                     ("update_block.encoder.convf1", "update_block.motion_encoder.convflow1.0"),
                     ("update_block.encoder.convf2", "update_block.motion_encoder.convflow2.0"),
                     ("update_block.encoder.conv.", "update_block.motion_encoder.conv.0."),
                     ("update_block.mask.0", "mask_predictor.convrelu.0"),
                     ("update_block.mask.2", "mask_predictor.conv")):
            k = k.replace(a, b)
        for g in (1, 2):
            for gate in "zrq":
                k = k.replace(f"update_block.gru.conv{gate}{g}",
                              f"update_block.recurrent_block.convgru{g}.conv{gate}")
        for src, dst in (("fnet", "feature_encoder"), ("cnet", "context_encoder")):
            if k.startswith(src + ".layer"):
                for a, b in ((".conv1.", ".convnormrelu1.0."), (".norm1.", ".convnormrelu1.1."),
                             (".conv2.", ".convnormrelu2.0."), (".norm2.", ".convnormrelu2.1.")):
                    k = k.replace(a, b)
                k = dst + k[len(src):]
            for a, b in ((".conv1.", ".convnormrelu.0."), (".norm1.", ".convnormrelu.1."),
                         (".conv2.", ".conv.")):
                if k.startswith(src + a):
                    k = dst + b + k[len(src + a):]
        out[k] = v
    return out


def test_load_raft_reads_princeton_and_torchvision_layouts():
    cfg = tr.RAFTConfig.tiny()
    sd = _princeton_state_dict(cfg, np.random.default_rng(2))
    tv = _to_torchvision(sd)
    assert any(k.startswith("feature_encoder.") for k in tv) and len(tv) < len(sd)
    a, b = tcv.load_raft(sd, cfg), tcv.load_raft(tv, cfg)
    assert not a.training
    state = a.state_dict()
    assert state.keys() == b.state_dict().keys()
    for k, v in state.items():
        torch.testing.assert_close(b.state_dict()[k], v, atol=0, rtol=0)
        np.testing.assert_array_equal(v.numpy(), sd["module." + k], err_msg=k)


@pytest.mark.parametrize("fault", ["stray", "missing", "norm3"])
def test_load_raft_is_strict(fault):
    cfg = tr.RAFTConfig.tiny()
    sd = _princeton_state_dict(cfg, np.random.default_rng(3))
    if fault == "stray":
        sd["module.update_block.gru.bogus.weight"] = np.zeros(1, np.float32)
    elif fault == "missing":
        sd.pop("module.update_block.flow_head.conv2.bias")
    else:  # a norm3 that is not its downsample.1 twin
        sd["module.cnet.layer2.0.norm3.bias"] = sd["module.cnet.layer2.0.norm3.bias"] + 1.0
    with pytest.raises(RuntimeError, match={"stray": "bogus", "missing": "conv2.bias",
                                            "norm3": "norm3"}[fault]):
        tcv.load_raft(sd, cfg)


def test_smoothing_with_raft_flow_matches_jax(tiny_pair):
    """``sliding_window_smooth`` driven by RAFT (the ``--flow raft``
    smoother): 3 frames, radius 1, the tiny RAFT's 8 flows in one batch on
    the port's side, one compiled call per flow on the JAX side."""
    from univst_tpu.methods.flow import sliding_window_smooth as j_smooth
    from univst_torch.methods.flow import sliding_window_smooth

    cfg, params, imgs, _ = tiny_pair
    frames = np.concatenate([imgs[0], imgs[1, :1]])
    want = np.asarray(j_smooth(jnp.asarray(frames), jax.jit(jr.make_raft_flow(params, cfg)),
                               radius=1))
    got = sliding_window_smooth(torch.tensor(frames), tr.make_raft_flow(_torch_raft(params)),
                                radius=1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
