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
