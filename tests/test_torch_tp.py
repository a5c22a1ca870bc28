"""SD3 / SD3.5 on a ``('data', 'tensor')`` mesh: the port's tensor
parallelism (``univst_torch.distributed.tp``) with frame parallelism, on
gloo ranks on the CPU, against the JAX package's one-device forward and
pipeline on the same numpy inputs and weights.

Each multi-process case spawns its ranks through ``_torch_dist.run_ranks``.

Tolerances are the JAX package's own sharded-against-single-device bars:
the MMDiT forward at ``atol=3e-4`` (tests/test_distributed.py:86), the
pipeline's ``stylize_latents`` and ``invert`` at ``rtol=atol=3e-4``
(:198-202).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td

F, PX, N = 4, 64, 4
H8 = PX // 8
T = 500.0


def _leaf_ids(params):
    """``params`` with every leaf filled with its own index (a marker that
    survives the converter's transposes and reshapes); returns the tree
    and the leaves' paths by index."""
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    marked = [np.full(leaf.shape, i, np.float32) for i, (_, leaf) in enumerate(leaves)]
    return jax.tree_util.tree_unflatten(tree, marked), [path for path, _ in leaves]


def test_role_table_follows_the_jax_rules():
    """Every parameter of the tiny SD3.5-medium MMDiT (dual attention, q/k
    RMS norms) carries the split ``univst_tpu.distributed.tp._spec_for``
    gives its Flax path: a column-parallel weight split on its output
    features (the kernel's last axis), its bias split; a row-parallel
    weight split on its input features, its bias whole; the rest whole."""
    from jax.sharding import PartitionSpec as P

    from univst_tpu.distributed.tp import _spec_for
    from univst_tpu.models.layers import VideoCtx
    from univst_tpu.models.mmdit import MMDiT as JMMDiT
    from univst_tpu.models.mmdit import MMDiTConfig as JCfg
    from univst_torch.distributed.tp import role
    from univst_torch.models import convert as tcv

    cfg = JCfg.tiny(num_heads=4, head_dim=16, qk_norm="rms", dual_attention_layers=(0,))
    x = jnp.zeros((F, 8, 8, 16))
    params = jax.eval_shape(lambda: JMMDiT(cfg).init(
        jax.random.PRNGKey(0), x, jnp.asarray(T), jnp.zeros((1, 10, cfg.joint_attention_dim)),
        jnp.zeros((1, cfg.pooled_projection_dim)), VideoCtx(num_frames=F)))["params"]
    marked, paths = _leaf_ids(params)
    state = tcv.flax_mmdit_to_state_dict(marked, cfg)
    want = {"column": {"weight": P(None, "tensor"), "bias": P("tensor")},
            "row": {"weight": P("tensor", None), "bias": P()}}
    checked = {"column": 0, "row": 0, "replicated": 0}
    for key, value in state.items():
        if key == "pos_embed.pos_embed":
            continue  # recomputed from the formula by both packages
        ids = np.unique(value)
        assert len(ids) == 1, key
        spec = _spec_for(paths[int(ids[0])])
        module, _, param = key.rpartition(".")
        kind = role(module)
        assert spec == want.get(kind, {}).get(param, P()), key
        checked[kind] += 1
    # weights and biases: block 0 holds 6 q/k/v projections, 3 in its dual
    # attention and 2 MLP fc1, block 1 (context_pre_only, no ff_context) 6
    # and 1; row: 5 (to_out, to_add_out, attn2's to_out, two fc2) and 2
    assert checked["column"] == 2 * (11 + 7) and checked["row"] == 2 * (5 + 2)
    assert checked["replicated"] > 0


def _mmdit_case(num_heads: int):
    """The tiny MMDiT with ``num_heads`` heads of 16 and q/k RMS norms, its
    JAX forward on 4 frames."""
    from univst_tpu.core.config import SD3_FRAME_INDICES
    from univst_tpu.models.layers import VideoCtx
    from univst_tpu.models.mmdit import MMDiT as JMMDiT
    from univst_tpu.models.mmdit import MMDiTConfig as JCfg
    from univst_torch.models import convert as tcv

    kw = dict(num_heads=num_heads, head_dim=16, qk_norm="rms", dual_attention_layers=(0,))
    cfg = JCfg.tiny(**kw)
    model = JMMDiT(cfg)
    vctx = VideoCtx(num_frames=F, frame_indices=SD3_FRAME_INDICES)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, F, 8, 8, 16)).astype(np.float32)
    ctx = rng.standard_normal((1, 10, cfg.joint_attention_dim)).astype(np.float32)
    pooled = rng.standard_normal((1, cfg.pooled_projection_dim)).astype(np.float32)
    params = model.init(jax.random.PRNGKey(3), jnp.asarray(x[0]), jnp.asarray(T),
                        jnp.asarray(ctx), jnp.asarray(pooled), vctx)["params"]
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x[0]), jnp.asarray(T),
                                  jnp.asarray(ctx), jnp.asarray(pooled), vctx)[0])
    state = tcv.to_torch_state_dict(tcv.flax_mmdit_to_state_dict(params, cfg))
    return kw, state, x, ctx, pooled, want[None]


@pytest.fixture(scope="module")
def mmdit_case():
    """4 heads of 16: tensor=2 and 4 divide them."""
    return _mmdit_case(4)


@pytest.fixture(scope="module")
def mmdit6_case():
    """6 heads of 16: tensor=4 divides the 96 q/k/v columns, not the heads."""
    return _mmdit_case(6)


@pytest.mark.parametrize("n_data, n_tensor", [(2, 2), (1, 2)])
def test_mmdit_on_a_data_tensor_mesh_matches_jax(n_data, n_tensor, mmdit_case, tmp_path):
    kw, state, x, ctx, pooled, want = mmdit_case
    res = td.run_ranks(td.mmdit_forward, n_data * n_tensor, tmp_path, state, kw, x, ctx,
                       pooled, T, mesh_tensor=n_tensor)
    for v, _, _, heads, _ in res:
        assert v.shape == want.shape
        np.testing.assert_allclose(v.numpy(), want, atol=3e-4)
        # the q/k RMS norms see the rank's heads only
        assert heads == [kw["num_heads"] // n_tensor]


@pytest.mark.parametrize("shift", [False, True], ids=["inversion", "stylization"])
def test_sd3_forward_moves_halo_all_to_alls_and_tensor_all_reduces(shift, mmdit_case,
                                                                  tmp_path):
    """Over the data group only the K/V halo (one all-to-all per joint and
    dual attention: frame 0 and the frame before the shard); over the
    tensor group four all-reduces a block (attention out, context out, the
    two MLPs), two in the ``context_pre_only`` last block, one more per
    dual attention. The per-head q/k RMS norms and, in the 3-branch
    stylization forward, the AdaIN shift see the rank's heads and add no
    collective. The profiler sees exactly these, op by op; the stylization
    forward matches the port on one process."""
    from collections import Counter

    import torch

    from univst_torch.core.config import SD3_FRAME_INDICES, SD3_STYLE_SHIFT
    from univst_torch.models.layers import StyleCtx, VideoCtx
    from univst_torch.models.mmdit import MMDiT, MMDiTConfig

    kw, state, x, ctx, pooled, _ = mmdit_case
    layers, duals = 2, 1
    branches = 3 if shift else 1
    if shift:  # [content | style | stylized]
        x = np.concatenate([x, 0.5 * x[:, ::-1], x + 0.1])
    res = td.run_ranks(td.mmdit_forward, 4, tmp_path, state, kw, x, ctx, pooled, T,
                       2 if shift else None, mesh_tensor=2)
    for rank, (v, recs, prof, heads, adain_heads) in enumerate(res):
        ops = Counter(op for op, *_ in recs)
        assert ops == Counter(all_to_all=layers + duals,
                              all_reduce=4 * (layers - 1) + 2 + duals)
        assert {site for op, _, site, _ in recs if op == "all_to_all"} == {"kv_halo"}
        assert prof == ops
        assert heads == [kw["num_heads"] // 2]
        # the shift's AdaIN of k and v in each joint and dual attention
        assert adain_heads == ([kw["num_heads"] // 2] * 2 * (layers + duals) if shift else [])
        halo = [nb for op, nb, *_ in recs if op == "all_to_all"]
        # data rank 1 of 2 holds frames 2-3: frames 0 and 1 arrive, K and V
        # of its 2 heads of 16 at 16 tokens, per branch; data rank 0 needs none
        per = branches * 2 * 2 * 16 * (kw["num_heads"] // 2) * kw["head_dim"] * 4
        assert halo == [per if rank // 2 == 1 else 0] * (layers + duals)
    if shift:
        model = MMDiT(MMDiTConfig.tiny(**kw)).eval()
        model.load_state_dict(state, strict=True)
        with torch.inference_mode():
            want, _ = model(torch.tensor(x.reshape((-1,) + x.shape[2:])), T,
                            torch.tensor(ctx).expand(3, -1, -1),
                            torch.tensor(pooled).expand(3, -1),
                            VideoCtx(num_frames=F, frame_indices=SD3_FRAME_INDICES),
                            StyleCtx(step_idx=2, cfg=SD3_STYLE_SHIFT))
        np.testing.assert_allclose(res[0][0].reshape(want.shape).numpy(), want.numpy(),
                                   atol=3e-4)


@pytest.mark.parametrize("n_data", [1, 2])
def test_mmdit_with_uneven_heads_on_tensor_4_matches_jax(n_data, mmdit6_case, tmp_path):
    """6 heads over ``tensor=4`` (as SD3.5-large's 38: 10, 10, 9, 9): the
    tensor ranks take 2, 2, 1 and 1 whole heads, the MLPs' 384 features 96
    each; the forward matches JAX and is the same on every rank, bit for
    bit (each all-reduce leaves the tensor ranks' activations equal)."""
    kw, state, x, ctx, pooled, want = mmdit6_case
    res = td.run_ranks(td.mmdit_forward, n_data * 4, tmp_path, state, kw, x, ctx, pooled, T,
                       mesh_tensor=4)
    assert [heads for _, _, _, heads, _ in res] == [[2], [2], [1], [1]] * n_data
    for v, recs, _, _, _ in res:
        assert v.shape == want.shape
        np.testing.assert_allclose(v.numpy(), want, atol=3e-4)
        assert torch.equal(v, res[0][0])
        # the all-reduces carry whole activations: the same bytes on every rank
        assert ([nb for op, nb, *_ in recs if op == "all_reduce"]
                == [nb for op, nb, *_ in res[0][1] if op == "all_reduce"])


@pytest.mark.parametrize("num_heads, head_dim, n_tensor, refusal", [
    (38, 64, 4, None),  # SD3.5-large: 10, 10, 9, 9 heads a rank
    (38, 64, 2, None),
    (4, 16, 3, "64 q/k/v columns"),  # as the JAX rules: 3 does not divide 64 columns
    (2, 16, 4, "no whole head"),  # more ranks than heads
], ids=["sd35l_tensor4", "sd35l_tensor2", "tiny_tensor3", "tiny_more_ranks_than_heads"])
def test_tensor_axis_must_divide_the_heads(num_heads, head_dim, n_tensor, refusal,
                                           mmdit_case, tmp_path):
    """``check_heads`` refuses what the JAX package cannot place (a tensor
    axis that does not divide the q/k/v columns) and an axis with more
    ranks than heads; the 4-head MMDiT on 3 tensor ranks is refused by the
    ranks themselves."""
    from univst_torch.distributed.tp import check_heads

    if refusal is None:
        check_heads(num_heads, n_tensor, head_dim)
        return
    reason = f"does not divide the MMDiT's {num_heads} heads of {head_dim}: .*{refusal}"
    with pytest.raises(ValueError, match=reason):
        check_heads(num_heads, n_tensor, head_dim)
    kw, state, x, ctx, pooled, _ = mmdit_case
    if (num_heads, head_dim) == (kw["num_heads"], kw["head_dim"]):
        with pytest.raises(AssertionError, match=reason):
            td.run_ranks(td.mmdit_forward, n_tensor, tmp_path, state, kw, x, ctx, pooled, T,
                         mesh_tensor=n_tensor)


def test_sd35_large_on_tensor_4_passes_the_cli_check(tmp_path):
    """``run_workflow --backbone sd3 --variant sd35 --mesh data=1,tensor=4``
    gets past the CLIs' head check (``cli/common.py``) and stops only where
    one process is not the mesh's 4 ranks."""
    import os

    from univst_torch.cli import run_workflow

    ex = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
    argv = ["--backbone", "sd3", "--variant", "sd35", "--platform", "cpu", "--num_frames", "4",
            "--height", "64", "--width", "64", "--time_steps", "2", "--ft_indices", "1",
            "--ft_timesteps", "1", "--mesh", "data=1,tensor=4",
            "--content_path", os.path.join(ex, "contents", "demo-fly-tiny"),
            "--style_path", os.path.join(ex, "styles", "tiny-00033.png"),
            "--mask_path", os.path.join(ex, "masks", "demo-fly-tiny.png"),
            "--output_root", str(tmp_path)]
    with pytest.raises(SystemExit, match="needs 4 ranks"):
        run_workflow.main(run_workflow.build_parser().parse_args(argv))


@pytest.fixture(scope="module")
def sd3_case():
    from univst_tpu.core.config import SD3_STYLE_SHIFT as J_SHIFT
    from univst_tpu.core.config import StyleShiftConfig as JShift
    from univst_tpu.core.config import StyleTransferConfig as JSTCfg
    from univst_tpu.pipelines.sd3 import SD3VideoPipeline as JPipe
    from univst_torch.models import convert as tcv

    jp = JPipe.build(variant="tiny", num_frames=F, height=PX, width=PX, dtype=jnp.float32,
                     seed=0)
    states = [tcv.to_torch_state_dict(emit(params, cfg)) for emit, params, cfg in (
        (tcv.flax_mmdit_to_state_dict, jp.mmdit_params, jp.mmdit.cfg),
        (tcv.flax_vae_to_state_dict, jp.vae_params, jp.vae.cfg),
        (tcv.flax_clip_to_state_dict, jp.clip_l_params, jp.clip_l.cfg),
        (tcv.flax_clip_to_state_dict, jp.clip_g_params, jp.clip_g.cfg),
        (tcv.flax_t5_to_state_dict, jp.t5_params, jp.t5.cfg))]
    rng = np.random.default_rng(2)
    style1 = rng.standard_normal((N + 1, 1, H8, H8, 16)).astype(np.float32)
    inputs = dict(content=rng.standard_normal((N + 1, F, H8, H8, 16)).astype(np.float32),
                  style=style1, init=rng.standard_normal((F, H8, H8, 16)).astype(np.float32),
                  img=rng.standard_normal((F, H8, H8, 16)).astype(np.float32),
                  mask=(rng.random((F, PX, PX)) > 0.5).astype(np.float32))
    # a window inside the 4 steps: both stylization phases run
    shift = dataclasses.asdict(dataclasses.replace(J_SHIFT, num_steps=N))
    ctx, pooled = jp.encode_prompt("")
    ctx3, pooled3 = jnp.concatenate([ctx] * 3), jnp.concatenate([pooled] * 3)
    out = jp.stylize_latents(jnp.asarray(inputs["content"]), jnp.asarray(style1),
                             jnp.asarray(inputs["init"]), jnp.asarray(inputs["img"]), ctx3,
                             pooled3, mask=jnp.asarray(inputs["mask"]),
                             cfg=JSTCfg(num_steps=N), style_cfg=JShift(**shift))
    traj = jp.invert(jnp.asarray(inputs["init"]), ctx, pooled, num_steps=N)[0]
    return states, inputs, shift, (np.asarray(out), np.asarray(traj))


def test_sd3_pipeline_on_a_data_tensor_mesh_matches_jax(sd3_case, tmp_path):
    """The tiny SD3 pipeline's stylization (style-singleton 2-branch phase
    with the single-frame capture on every rank, the stylized-only phase,
    mask blend, AdaIN re-anchor) and RF-Inversion on ``data=2,tensor=2``
    (2 heads: one a tensor rank; 2 frames a data rank)."""
    states, inputs, shift, want = sd3_case
    got = td.run_ranks(td.sd3_pipeline, 4, tmp_path, states, F, N, inputs, shift,
                       mesh_tensor=2)
    for rank_out in got:
        for g, w in zip(rank_out, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w, rtol=3e-4, atol=3e-4)
