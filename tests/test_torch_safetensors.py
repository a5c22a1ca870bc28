"""The port's own safetensors reader and writer
(``univst_torch/utils/safetensors.py``) against the ``safetensors``
package, and the sharded checkpoint folders that
``univst_torch/models/convert.py`` reads through a ``*.index.json``.

Checked: the reader gives ``safetensors``' tensors for every dtype it
knows (shapes of rank 0 and empty ones included); the writer's files are
byte for byte ``safetensors.numpy.save_file``'s (and
``safetensors.torch.save_file``'s for bf16); malformed headers are refused
with the file named; a tiny SD3 directory whose ``transformer`` and
``text_encoder_3`` are split into two shards loads equal to the one-file
directory and to the JAX package's load of it; a bad index is refused.
"""

import json
import os
import shutil
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy as snp
import safetensors.torch as stt
import torch

from _torch_parity import seeded_init
from univst_torch.models import convert as tcv
from univst_torch.utils import safetensors as ust

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
SHAPES = [(3, 5), (), (0, 4), (2, 1, 3)]


def _tensor(dtype, shape, rng):
    x = torch.from_numpy(np.asarray(rng.standard_normal(shape) * 50))
    if dtype == torch.bool:
        return x > 0
    return x.to(dtype)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_reader_equals_safetensors(name, tmp_path):
    rng = np.random.default_rng(0)
    dtype = DTYPES[name]
    tensors = {f"t{i}": _tensor(dtype, s, rng) for i, s in enumerate(SHAPES)}
    tensors["other.f32"] = _tensor(torch.float32, (7,), rng)  # another dtype's range
    path = tmp_path / "x.safetensors"
    stt.save_file(tensors, str(path))
    got, want = ust.load_file(str(path)), stt.load_file(str(path))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k
    if name != "BF16":
        for k, v in snp.load_file(str(path)).items():
            np.testing.assert_array_equal(got[k].numpy(), v)


def _numpy_dict(seed: int):
    rng = np.random.default_rng(seed)
    kinds = [np.float64, np.float32, np.float16, np.int64, np.int32, np.int16, np.int8,
             np.uint8, np.bool_]
    out = {}
    for i in range(12):
        kind = kinds[int(rng.integers(len(kinds)))]
        shape = tuple(int(d) for d in rng.integers(0, 4, size=int(rng.integers(0, 4))))
        name = ["w", "block.0.weight", "émb", "a.b", "z_9"][i % 5] + f".{int(rng.integers(99))}"
        out[name] = np.asarray(rng.standard_normal(shape) * 9).astype(kind)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_writer_is_byte_identical_to_safetensors_numpy(seed, tmp_path):
    tensors = _numpy_dict(seed)
    snp.save_file(tensors, str(tmp_path / "ref.safetensors"))
    n = ust.save_file(tensors, str(tmp_path / "mine.safetensors"))
    ref = (tmp_path / "ref.safetensors").read_bytes()
    assert (tmp_path / "mine.safetensors").read_bytes() == ref and n == len(ref)
    # the same dict as torch tensors writes the same bytes
    ust.save_file({k: torch.from_numpy(v) for k, v in tensors.items()},
                  str(tmp_path / "torch.safetensors"))
    assert (tmp_path / "torch.safetensors").read_bytes() == ref


def test_writer_bf16_is_byte_identical_to_safetensors_torch(tmp_path):
    rng = np.random.default_rng(3)
    tensors = {"b": _tensor(torch.bfloat16, (4, 3), rng), "a": _tensor(torch.float16, (5,), rng),
               "c": _tensor(torch.int64, (), rng), "d": _tensor(torch.bfloat16, (0,), rng),
               "e": _tensor(torch.float32, (2, 2), rng).t()}  # not contiguous
    stt.save_file({k: v.contiguous() for k, v in tensors.items()}, str(tmp_path / "ref.st"))
    ust.save_file(tensors, str(tmp_path / "mine.st"))
    assert (tmp_path / "mine.st").read_bytes() == (tmp_path / "ref.st").read_bytes()
    got = ust.load_file(str(tmp_path / "mine.st"))
    assert all(torch.equal(got[k], v) for k, v in tensors.items())


def _raw(header, data: bytes, length=None) -> bytes:
    h = json.dumps(header).encode()
    return struct.pack("<Q", len(h) if length is None else length) + h + data


F32_2 = {"dtype": "F32", "shape": [2]}
TWICE = (b'{"a":{"dtype":"U8","shape":[1],"data_offsets":[0,1]},'
         b'"a":{"dtype":"U8","shape":[1],"data_offsets":[1,2]}}')
MALFORMED = {
    "short file": b"\x01\x02",
    "header length past the end": _raw({}, b"", length=999),
    "not json": struct.pack("<Q", 3) + b"{x:",
    "unknown dtype": _raw({"a": {"dtype": "Q7", "shape": [2], "data_offsets": [0, 2]}},
                          b"\0" * 2),
    "offset past the end": _raw({"a": dict(F32_2, data_offsets=[0, 8]),
                                 "b": dict(F32_2, data_offsets=[8, 16])}, b"\0" * 12),
    "overlapping ranges": _raw({"a": dict(F32_2, data_offsets=[0, 8]),
                                "b": dict(F32_2, data_offsets=[4, 12])}, b"\0" * 12),
    "a gap": _raw({"a": dict(F32_2, data_offsets=[0, 8]),
                   "b": dict(F32_2, data_offsets=[12, 20])}, b"\0" * 20),
    "range not the shape's bytes": _raw({"a": dict(F32_2, data_offsets=[0, 12])}, b"\0" * 12),
    "a name twice": struct.pack("<Q", len(TWICE)) + TWICE + b"\0\0",
    "bytes after the last range": _raw({"a": dict(F32_2, data_offsets=[0, 8])}, b"\0" * 9),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_header_is_refused_naming_the_file(case, tmp_path):
    path = tmp_path / "bad.safetensors"
    path.write_bytes(MALFORMED[case])
    with pytest.raises(ValueError, match="bad.safetensors"):
        ust.load_file(str(path))


def test_unaligned_offsets_are_read(tmp_path):
    """A file whose ranges are not aligned to their element size (an older
    writer's order) still reads, copied out of the map."""
    a, b = np.arange(3, dtype=np.uint8), np.arange(4, dtype=np.float32)
    path = tmp_path / "u.safetensors"
    path.write_bytes(_raw({"a": {"dtype": "U8", "shape": [3], "data_offsets": [0, 3]},
                           "b": {"dtype": "F32", "shape": [4], "data_offsets": [3, 19]}},
                          a.tobytes() + b.tobytes()))
    got = ust.load_file(str(path))
    np.testing.assert_array_equal(got["b"].numpy(), b)
    np.testing.assert_array_equal(got["a"].numpy(), a)


# -- sharded folders ---------------------------------------------------------------


def _shard(folder, name="model.safetensors", parts=2) -> dict:
    """Split ``folder/name`` into ``parts`` shards plus an index, as the
    released sharded folders are laid out; the one file is removed."""
    single = os.path.join(folder, name)
    sd = ust.load_file(single)
    keys = sorted(sd)
    stem = name[:-len(".safetensors")]
    weight_map = {}
    for i in range(parts):
        shard = f"{stem}-{i + 1:05d}-of-{parts:05d}.safetensors"
        part = {k: sd[k] for k in keys[i::parts]}
        ust.save_file(part, os.path.join(folder, shard))
        weight_map.update({k: shard for k in part})
    del sd
    os.remove(single)
    with open(os.path.join(folder, name + ".index.json"), "w") as f:
        json.dump({"metadata": {"total_size": 0}, "weight_map": weight_map}, f)
    return weight_map


@pytest.fixture(scope="module")
def sd3_dirs(tmp_path_factory):
    from univst_torch.tools import make_synthetic_checkpoints as msc

    root = tmp_path_factory.mktemp("sd3_shards")
    msc.main(["--root", str(root / "single"), "--families", "sd3", "--platform", "cpu"])
    shutil.copytree(root / "single", root / "sharded")
    _shard(str(root / "sharded" / "sd3" / "transformer"), "diffusion_pytorch_model.safetensors")
    _shard(str(root / "sharded" / "sd3" / "text_encoder_3"))
    return root / "single" / "sd3", root / "sharded" / "sd3"


def _sd3_modules(path):
    from univst_torch.pipelines.sd3 import SD3VideoPipeline

    pipe = SD3VideoPipeline.build(pretrained_model_path=str(path), variant="tiny", num_frames=4,
                                  dtype=torch.float32, seed=1, device="cpu")
    return {"transformer": pipe.mmdit, "vae": pipe.vae, "text_encoder": pipe.clip_l,
            "text_encoder_2": pipe.clip_g, "text_encoder_3": pipe.t5}


def test_sharded_sd3_folder_loads_equal_to_one_file_and_to_jax(sd3_dirs):
    single, sharded = sd3_dirs
    assert tcv._find_weights(str(sharded / "transformer")).endswith(".index.json")
    one, two = _sd3_modules(single), _sd3_modules(sharded)
    for sub in one:
        a, b = one[sub].state_dict(), two[sub].state_dict()
        assert list(a) == list(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (sub, k)

    from univst_tpu.pipelines.sd3 import SD3VideoPipeline as JSD3

    with seeded_init(5):
        jpipe = JSD3.build(pretrained_model_path=str(single), variant="tiny", num_frames=4,
                           height=64, width=64, dtype=jnp.float32)
    for sub, emitted in (
            ("transformer", tcv.flax_mmdit_to_state_dict(jpipe.mmdit_params, jpipe.mmdit.cfg)),
            ("text_encoder_3", tcv.flax_t5_to_state_dict(jpipe.t5_params, jpipe.t5.cfg))):
        state = two[sub].state_dict()
        assert set(emitted) == set(state)
        for k, v in emitted.items():
            if k != "pos_embed.pos_embed":  # both packages recompute the table
                np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)


def _index(folder, weight_map, raw=None):
    path = os.path.join(folder, "model.safetensors.index.json")
    with open(path, "w") as f:
        f.write(raw if raw is not None else json.dumps({"weight_map": weight_map}))
    return path


def test_bad_shard_index_is_refused(sd3_dirs, tmp_path):
    _, sharded = sd3_dirs
    folder = tmp_path / "t5"
    shutil.copytree(sharded / "text_encoder_3", folder)
    with open(folder / "model.safetensors.index.json") as f:
        weight_map = json.load(f)["weight_map"]
    assert len(tcv.load_state_dict_file(tcv._find_weights(str(folder)))) == len(weight_map)

    missing = dict(weight_map, **{k: "model-00003-of-00003.safetensors"
                                  for k in list(weight_map)[:1]})
    with pytest.raises(FileNotFoundError, match="model-00003-of-00003"):
        tcv.load_state_dict_file(_index(folder, missing))

    key, shard = next(iter(weight_map.items()))
    twice = json.dumps({"weight_map": weight_map})[:-2] + f', "{key}": "{shard}"}}}}'
    with pytest.raises(ValueError, match="twice"):
        tcv.load_state_dict_file(_index(folder, None, raw=twice))

    other = next(s for s in set(weight_map.values()) if s != shard)
    moved = dict(weight_map, **{key: other})  # the key lies in the other shard
    with pytest.raises(ValueError, match="does not map"):
        tcv.load_state_dict_file(_index(folder, moved))

    with pytest.raises(FileNotFoundError):
        tcv.load_state_dict_file(_index(folder, dict(weight_map, **{key: "../x.safetensors"})))


def test_one_file_folders_keep_their_order_of_preference(tmp_path):
    for name in ("b.pt", "a.bin", "z.safetensors"):
        (tmp_path / name).write_bytes(b"")
    assert tcv._find_weights(str(tmp_path)).endswith("z.safetensors")
    os.remove(tmp_path / "z.safetensors")
    assert tcv._find_weights(str(tmp_path)).endswith("a.bin")
    assert tcv._find_weights(str(tmp_path / "none")) is None
