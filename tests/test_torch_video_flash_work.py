"""The video flash attention work count (FLOPs, exponentials, bytes) against
hand-worked cases. Pure arithmetic on shapes: runs on the CPU."""

import pytest

from univst_torch.attention.video_flash import slot_tables, work


def test_k1_main_shape_keeps_45_slots():
    # (-1, 0, 'first') at F=16: frame 0 keeps {0}, frame 1 {0, 1}, frames
    # 2..15 {f-1, f, 0}: 1 + 2 + 14 * 3 = 45 kept slots of 4096 keys
    b, f, h, lq, l, dh = 2, 16, 8, 4096, 4096, 40
    _, mult = slot_tables((-1, 0, "first"), f)
    assert int((mult > 0).sum()) == 45
    w = work((b, f, h, lq, l, dh), (-1, 0, "first"))
    assert w.exps == b * h * lq * 4096 * 45 == 12_079_595_520
    assert w.flops == 4 * dh * w.exps
    # q and out, and all 16 frames' K and V (every frame is a source), bf16
    assert w.bytes == 2 * (2 * b * f * h * lq * dh + 2 * b * f * h * l * dh)


def test_duplicate_slots_are_counted_once():
    # ('first', 'first', 0) at F=4: frame 0 names frame 0 three times (1 kept),
    # frames 1..3 name {0, f} (2 kept each): 7 kept slots, not 12
    w = work((1, 4, 1, 8, 16, 8), ("first", "first", 0))
    assert w.exps == 8 * 16 * 7
    assert w.flops == 4 * 8 * 8 * 16 * 7


def test_ctx_term_counts_valid_rows_only():
    # one slot (-1) at F=2 keeps frame 0 for both frames: 2 kept slots; each
    # frame adds its 77 valid context keys (of however many rows it holds)
    b, f, h, lq, l, dh = 1, 2, 3, 10, 32, 64
    w = work((b, f, h, lq, l, dh), (-1,), ctx_valid=77)
    keys = 32 * 2 + 77 * 2
    assert w.exps == b * h * lq * keys
    assert w.flops == 4 * dh * b * h * lq * keys
    # q + out, frame 0's K/V only (frame 1 is nobody's source), the valid ctx
    assert w.bytes == 2 * b * h * dh * (2 * f * lq + 2 * 1 * l + 2 * f * 77)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_bytes_follow_the_element_size(itemsize):
    w = work((1, 4, 2, 300, 256, 40), ("first", -1, 0), ctx_valid=77, itemsize=itemsize)
    assert w.bytes == itemsize * 2 * 40 * (2 * 4 * 300 + 2 * 4 * 256 + 2 * 4 * 77)


def test_shard_tables_work_counts_the_rank_and_its_halo():
    # rank 1 of 2 at F=16, (-1, 0, 'first'): frames 8..15 each keep 3 slots
    # (no duplicates away from frame 0): 24 kept slots; it reads its own 8
    # frames' K/V and the halo frames 0 and 7: 10 frames
    from univst_torch.attention.ops import shard_kv_tables

    b, h, lq, l, dh = 2, 8, 4096, 4096, 40
    halo, srcs, mult = shard_kv_tables((-1, 0, "first"), 16, 8, 8)
    w = work((b, 8, h, lq, l, dh), (-1, 0, "first"), tables=(srcs, mult))
    assert w.exps == b * h * lq * l * 24
    assert w.bytes == 2 * (2 * b * 8 * h * lq * dh + 2 * b * 10 * h * l * dh)
    # rank 0 holds frame 0 (one kept slot of weight 3) and needs no halo
    halo0, srcs0, mult0 = shard_kv_tables((-1, 0, "first"), 16, 0, 8)
    w0 = work((b, 8, h, lq, l, dh), (-1, 0, "first"), tables=(srcs0, mult0))
    assert halo0 == () and w0.exps == b * h * lq * l * (1 + 2 + 6 * 3)
    # the one-device call is the explicit-table call with Fk = F
    assert work((b, 16, h, lq, l, dh), (-1, 0, "first")) == work(
        (b, 16, h, lq, l, dh), (-1, 0, "first"), tables=slot_tables((-1, 0, "first"), 16))


@pytest.mark.parametrize("indices", [(-1, 0, "first"), (-1, "first"), ("first", -1, 0)])
def test_plain_version_with_explicit_tables_at_fk_equal_f_is_the_default(indices):
    """On the CPU the wrappers run their plain versions: the explicit-table
    call with the index set's own tables equals the default call exactly,
    in both layouts, with and without context."""
    import torch

    from univst_torch.attention.video_flash import (
        decode_tables, encode_tables, video_flash_attention, video_flash_attention_tokens,
    )

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 4, 2, 40, 16, generator=gen) for _ in range(3))
    ck, cv = (torch.randn(2, 4, 2, 9, 16, generator=gen) for _ in range(2))
    tables = slot_tables(indices, 4)
    assert all((a == b).all() for a, b in zip(decode_tables(encode_tables(*tables), 4), tables))
    for kw in ({}, dict(ctx_k=ck, ctx_v=cv, ctx_valid=7)):
        assert torch.equal(video_flash_attention(q, k, v, indices, **kw),
                           video_flash_attention(q, k, v, indices, tables=tables, **kw))
        tm = {key: (x.transpose(2, 3).contiguous() if torch.is_tensor(x) else x)
              for key, x in kw.items()}
        qt, kt, vt = (x.transpose(2, 3).contiguous() for x in (q, k, v))
        assert torch.equal(video_flash_attention_tokens(qt, kt, vt, indices, **tm),
                           video_flash_attention_tokens(qt, kt, vt, indices, tables=tables, **tm))


def test_explicit_tables_are_checked():
    import torch

    from univst_torch.attention.video_flash import video_flash_attention

    q = torch.zeros(1, 2, 1, 8, 8)
    k = torch.zeros(1, 3, 1, 8, 8)
    srcs, mult = slot_tables((-1, "first"), 2)
    with pytest.raises(ValueError, match="disagree"):
        video_flash_attention(q, k, k, (-1, "first"))  # Fk != F needs tables
    with pytest.raises(ValueError, match="outside"):
        video_flash_attention(q, k, k, (-1, "first"), tables=(srcs + 3, mult))
    with pytest.raises(ValueError, match="slot tables"):
        video_flash_attention(q, k, k, (-1, "first"), tables=(srcs[:1], mult[:1]))
    assert video_flash_attention(q, k, k, (-1, "first"), tables=(srcs + 1, mult)).shape == q.shape
