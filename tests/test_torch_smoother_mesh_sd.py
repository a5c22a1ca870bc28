"""The tiny SD pipeline's ``stylize_latents(smoother='pixel')`` frame-parallel
(``--mesh data=N``) on 2 and 4 gloo ranks on the CPU, on the style-singleton,
capture-and-inject and batched pre-pass paths, against the port on one
process and against the JAX package on the same numpy inputs: one
``smooth_halo`` all-to-all a smoothing step, each rank's flow batch its own
keys' pairs.

Its own file so that pytest-xdist's ``--dist loadfile`` runs it on another
worker than the rest of ``test_torch_smoother_mesh.py``, whose inputs,
census check and tolerances it shares: against one process at ``rtol=2e-4,
atol=2e-5`` (the JAX package's sharded-against-single-device bar,
tests/test_distributed.py:89-125), against JAX at 1e-3 of the max
(``test_torch_smoother.py``'s).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist as td
from _torch_parity import rel_err, seeded_init
from test_torch_smoother_mesh import (
    F, N, PX, SMOOTH, _check_census, _jax_stylize, _pipe_inputs, _states,
)

SD_SHIFT = dict(alpha=0.65, gamma=3.0, eta2=0.5, num_steps=N, window_mode="sd")
SD_PATHS = [dict(style_singleton=True), dict(style_singleton=False),
            dict(style_singleton=False, style_prepass_chunk=2)]


@pytest.fixture(scope="module")
def sd_smooth_case():
    from univst_tpu.pipelines.sd import SDVideoPipeline as JPipe
    from univst_torch.models import convert as tcv

    with seeded_init(0):
        jp = JPipe.build(variant="tiny", num_frames=F, height=PX, width=PX, dtype=jnp.float32,
                         capture_up_block=2, seed=0)
    inputs = _pipe_inputs(0, 1)
    states = _states(jp, tcv.flax_unet_to_state_dict)
    one = [td.smoothed_stylization(None, "sd", states, F, inputs, SD_SHIFT, SMOOTH, [path])[0]
           for path in SD_PATHS]
    return states, inputs, _jax_stylize(jp, inputs, SD_SHIFT), one


@pytest.fixture(scope="module")
def sd_smooth_runs(sd_smooth_case, tmp_path_factory):
    """Both SD paths on n ranks, one spawn per n."""
    states, inputs, _, _ = sd_smooth_case
    runs = {}

    def get(n):
        if n not in runs:
            runs[n] = td.run_ranks(td.smoothed_stylization, n,
                                   tmp_path_factory.mktemp(f"sd{n}"), "sd", states, F, inputs,
                                   SD_SHIFT, SMOOTH, SD_PATHS)
        return runs[n]

    return get


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("path", range(len(SD_PATHS)), ids=["singleton", "capture", "prepass"])
def test_sharded_sd_stylization_with_the_smoother_matches_one_process_and_jax(
        n, path, sd_smooth_case, sd_smooth_runs):
    _, _, want, one = sd_smooth_case
    per_rank = sd_smooth_runs(n)
    got = per_rank[0][path][0]
    assert got.shape == want.shape == (F, PX // 2, PX // 2, 4)
    np.testing.assert_allclose(got.numpy(), one[path][0].numpy(), rtol=2e-4, atol=2e-5)
    assert rel_err(got, want) < 1e-3
    for rank, runs in enumerate(per_rank):
        _check_census(runs[path][1], runs[path][2], rank, n)
