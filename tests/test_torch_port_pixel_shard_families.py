"""``parallel.shard_pixels`` in the other spatial families, on 2 CPU
ranks against the JAX package's sharded loss on 2 virtual devices
(tests/test_pixel_parallel.py:172-191, with grads): jiVAE's enumerated
branches (exact, and the top 2 of 5), ssiVAE's and ss_reg_iVAE's labelled
and unlabelled batches, each branch decoding the rank's 41 of 81 pixels;
both ranks' losses and every grad, encoder's and decoder's. Then the JAX
package's shards through its Pallas kernel in interpret mode against the
port's kernels' path. The harness, cases and tolerances are
tests/test_torch_port_pixel_shard.py's."""
import jax.numpy as jnp
import pytest

import pyroved_tpu.ops.spatial_decoder as sd
from pyroved_tpu_torch.ops import spatial_decoder as tsd

from test_torch_port_pixel_shard import check_case, launch_cases

FAMILIES = ["jivae_exact", "jivae_topk", "ssivae_unlabeled",
            "ssivae_labeled", "ss_reg_unlabeled", "ss_reg_labeled"]


@pytest.fixture(autouse=True, scope="module")
def f32_port():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsd, "BF16_MATMUL", False)
        yield


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch_cases(tmp_path_factory.mktemp("pixel_shard_families"),
                        FAMILIES + ["ivae_r_kernels"])


@pytest.mark.parametrize("name", FAMILIES)
def test_shard_pixels_families_match_jax(ranks, name):
    outs = check_case(*ranks, name)
    assert outs[0][name]["calls"] == {"K1": 1, "K2": 1, "K3": 0}


def test_shard_pixels_against_jax_pallas_interpret(ranks, monkeypatch):
    """tests/test_pixel_parallel.py:256-281: the JAX package's shards
    through its Pallas kernel in interpret mode (its gate opened)."""
    for name, value in (("INTERPRET", True), ("BF16_MATMUL", False),
                        ("ACT_DTYPE", jnp.float32)):
        monkeypatch.setattr(sd, name, value)
    monkeypatch.setattr(sd, "fused_profitable", lambda *a: True)
    monkeypatch.setattr(sd, "_forward", lambda *a: sd._fwd(*a))
    ranks[2]["ivae_r_kernels"][0]._fused = True
    try:
        check_case(*ranks, "ivae_r_kernels", cache=False)
    finally:
        ranks[2]["ivae_r_kernels"][0]._fused = False
