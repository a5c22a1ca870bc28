"""The port's ``utils/metrics.py`` and ``utils/lpips.py`` against the JAX
package's, on the CPU.

Metrics are float64 numpy in both packages: equal to 1e-12. LPIPS runs the
AlexNet trunk in fp32 in each framework: 1e-5 absolute on distances of
~0.1, with ``random_lpips_params`` drawing the same weights in both
packages and the strict loader fed torchvision / lpips-release layouts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univst_tpu.utils import lpips as jl
from univst_tpu.utils import metrics as jm
from univst_torch.utils import lpips as tl
from univst_torch.utils import metrics as tm


def _stacks(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (3, 24, 20, 3)).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-20, 21, a.shape), 0, 255).astype(np.uint8)
    return a, b


@pytest.mark.parametrize("fn", ["psnr", "ssim", "latent_mse"])
def test_metrics_match_jax(fn):
    a, b = _stacks()
    want, got = getattr(jm, fn)(a[0], b[0]), getattr(tm, fn)(a[0], b[0])
    assert isinstance(got, float) and abs(got - want) <= 1e-12 * max(1.0, abs(want))
    assert tm.psnr(a[0], a[0]) == float("inf")


def test_compare_frame_stacks_matches_jax():
    a, b = _stacks(1)
    want, got = jm.compare_frame_stacks(a, b), tm.compare_frame_stacks(a, b)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0)
    with pytest.raises(ValueError, match="mismatch"):
        tm.compare_frame_stacks(a, b[:2])


def _pair(seed=0, n=2, px=64):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (n, px, px, 3)).astype(np.float32) for _ in range(2)]


def test_lpips_with_random_params_matches_jax():
    a, b = _pair()
    want = np.asarray(jl.lpips_distance(jl.random_lpips_params(3), jnp.asarray(a),
                                        jnp.asarray(b)))
    got = tl.lpips_distance(tl.random_lpips_params(3), torch.tensor(a), torch.tensor(b))
    assert got.shape == want.shape == (2,) and np.all(want > 0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert float(tl.lpips_distance(tl.random_lpips_params(3), torch.tensor(a),
                                   torch.tensor(a)).abs().max()) == 0.0


@pytest.mark.parametrize("lin_layout", ["lin{i}.model.1.weight", "lins.{i}.model.1.weight",
                                        "{i}.weight"])
def test_lpips_loader_reads_the_released_layouts(lin_layout, tmp_path):
    """torchvision AlexNet (its classifier ignored) and the lpips heads in
    each layout the JAX converter takes, as dicts and as ``.pth`` files:
    the same distance as the JAX package's converter on the same dicts."""
    rng = np.random.default_rng(4)
    alex, lin, cin = {"classifier.1.weight": torch.zeros(4, 4)}, {}, 3
    for i, (fi, (cout, k, _, _)) in enumerate(zip((0, 3, 6, 8, 10), tl._ALEX_CONVS)):
        alex[f"features.{fi}.weight"] = torch.tensor(
            rng.normal(0, 0.05, (cout, cin, k, k)), dtype=torch.float32)
        alex[f"features.{fi}.bias"] = torch.tensor(rng.normal(0, 0.01, cout), dtype=torch.float32)
        lin[lin_layout.format(i=i)] = torch.tensor(
            np.abs(rng.normal(0, 0.1, (1, cout, 1, 1))), dtype=torch.float32)
        cin = cout
    a, b = _pair(5, n=1)
    want = np.asarray(jl.lpips_distance(jl.lpips_params_from_torch(alex, lin), jnp.asarray(a),
                                        jnp.asarray(b)))
    got = tl.lpips_distance(tl.lpips_params_from_torch(alex, lin), torch.tensor(a),
                            torch.tensor(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    torch.save(alex, tmp_path / "alex.pth")
    torch.save(lin, tmp_path / "lin.pth")
    from_files = tl.load_lpips_params(str(tmp_path / "alex.pth"), str(tmp_path / "lin.pth"))
    torch.testing.assert_close(tl.lpips_distance(from_files, torch.tensor(a), torch.tensor(b)),
                               got, atol=0, rtol=0)


@pytest.mark.parametrize("fault", ["stray lin", "missing conv"])
def test_lpips_loader_is_strict(fault):
    model = tl.random_lpips_params(0)
    alex = {k: v for k, v in model.state_dict().items() if k.startswith("features.")}
    lin = {k: v for k, v in model.state_dict().items() if k.startswith("lin")}
    if fault == "stray lin":
        lin["lin5.model.1.weight"] = lin["lin4.model.1.weight"]
        with pytest.raises(KeyError, match="lin5"):
            tl.lpips_params_from_torch(alex, lin)
    else:
        alex.pop("features.8.bias")
        with pytest.raises(RuntimeError, match="features.8.bias"):
            tl.lpips_params_from_torch(alex, lin)
