"""The port's load path needs neither ``safetensors`` nor ``transformers``
(a machine with the card is not promised either), and no fallback may hide
a missing card.

Checked: ``T5TokenizerShim`` with a ``tokenizer_3`` folder gives the null
prompt's ids with ``transformers`` hidden (equal to the JAX shim's through
``transformers``), raises naming the package for a non-empty prompt there,
and gives the JAX shim's ids for every prompt where the package is
present (the folder's ``tokenizer.json`` is a small Unigram vocabulary
built here with ``tokenizers``); ``make_mesh()`` without a device raises
where there is no CUDA; a checkpoint directory written by the port's tool
loads, and its SD3 pipeline encodes the null prompt, in a process where
``safetensors``, ``transformers`` and JAX cannot be imported; no source of
the port imports ``safetensors``, and only the tokenizer branch
``transformers``.
"""

import datetime
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_LEN = 12
PROMPTS = ["", "a cat", "the cats  ", "   "]


@pytest.fixture(scope="module")
def t5_folder(tmp_path_factory):
    """A ``tokenizer_3`` folder: T5's special ids (pad 0, </s> 1, unk 2),
    the SentencePiece metaspace and a handful of pieces."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, processors

    vocab = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0), ("▁", -2.0),
             ("▁a", -3.0), ("▁cat", -3.5), ("▁the", -3.0), ("c", -5.0),
             ("a", -5.0), ("t", -5.0), ("s", -5.0)]
    tok = Tokenizer(models.Unigram(vocab, unk_id=2, byte_fallback=False))
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always")
    tok.decoder = decoders.Metaspace(replacement="▁", prepend_scheme="always")
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", pair="$A </s> $B </s>", special_tokens=[("</s>", 1)])
    folder = tmp_path_factory.mktemp("ckpt") / "tokenizer_3"
    folder.mkdir()
    tok.save(str(folder / "tokenizer.json"))
    (folder / "tokenizer_config.json").write_text(json.dumps(dict(
        eos_token="</s>", pad_token="<pad>", unk_token="<unk>", extra_ids=0,
        model_max_length=512, tokenizer_class="T5Tokenizer")))
    return str(folder)


def _jax_ids(folder, prompt):
    from univst_tpu.models.t5 import T5TokenizerShim as JShim

    return JShim(folder, max_len=MAX_LEN)(prompt)


@pytest.mark.parametrize("prompt", PROMPTS)
def test_t5_shim_gives_the_jax_shims_ids(t5_folder, prompt):
    from univst_torch.models.t5 import T5TokenizerShim

    np.testing.assert_array_equal(T5TokenizerShim(t5_folder, max_len=MAX_LEN)(prompt),
                                  _jax_ids(t5_folder, prompt))


def test_t5_shim_without_transformers(t5_folder, monkeypatch):
    from univst_torch.models.t5 import T5TokenizerShim

    want = _jax_ids(t5_folder, "")
    assert want.tolist() == [[1] + [0] * (MAX_LEN - 1)]
    monkeypatch.setitem(sys.modules, "transformers", None)
    shim = T5TokenizerShim(t5_folder, max_len=MAX_LEN)
    np.testing.assert_array_equal(shim(""), want)
    np.testing.assert_array_equal(shim(["", ""]), np.concatenate([want, want]))
    with pytest.raises(ImportError, match="transformers"):
        shim("a cat")


def test_make_mesh_without_a_device_raises_without_cuda(tmp_path, monkeypatch):
    import torch.distributed as dist

    from univst_torch.distributed.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        assert make_mesh(device="cpu").device == torch.device("cpu")
    finally:
        dist.destroy_process_group()


LOAD_WITHOUT = """
import os, shutil, sys
for m in ("safetensors", "transformers", "jax", "flax", "univst_tpu"):
    sys.modules[m] = None
import torch
from univst_torch.pipelines.sd import SDVideoPipeline
from univst_torch.pipelines.sd3 import SD3VideoPipeline
from univst_torch.tools import make_synthetic_checkpoints as msc

root, tok = sys.argv[1], sys.argv[2]
msc.main(["--root", root, "--families", "sd,sd3", "--platform", "cpu"])
shutil.copytree(tok, os.path.join(root, "sd3", "tokenizer_3"))
kw = dict(variant="tiny", num_frames=4, dtype=torch.float32, device="cpu")
sd = SDVideoPipeline.build(pretrained_model_path=os.path.join(root, "sd"), seed=1, **kw)
want = SDVideoPipeline.build(seed=0, **kw)
assert all(torch.equal(a, b) for a, b in zip(sd.unet.state_dict().values(),
                                             want.unet.state_dict().values()))
pipe = SD3VideoPipeline.build(pretrained_model_path=os.path.join(root, "sd3"), seed=1, **kw)
assert pipe.tokenizer_3.hf_dir is not None
out = pipe.encode_prompt("")
assert all(torch.isfinite(t).all() for t in out)
print("loaded without", sorted(m for m in ("safetensors", "transformers")
                                 if sys.modules.get(m) is None))
"""


def test_load_path_runs_without_safetensors_and_transformers(t5_folder, tmp_path):
    res = subprocess.run([sys.executable, "-c", LOAD_WITHOUT, str(tmp_path / "ckpt"), t5_folder],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr[-4000:]
    assert "loaded without ['safetensors', 'transformers']" in res.stdout


def test_port_sources_import_neither_package():
    """No source of the port or ``chip_smoke.py`` imports ``safetensors``;
    ``transformers`` only in ``T5TokenizerShim``'s tokenizer branch."""
    import ast

    sources = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(base, f) for base, _, files in os.walk(os.path.join(REPO, "univst_torch"))
        for f in files if f.endswith(".py")]
    found = []
    for path in sources:
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            found += [(os.path.relpath(path, REPO), n.split(".")[0]) for n in names
                      if n.split(".")[0] in ("safetensors", "transformers")]
    assert found == [("univst_torch/models/t5.py", "transformers")]
