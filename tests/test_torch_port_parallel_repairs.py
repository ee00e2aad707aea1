"""Three repairs of the port's parallel layer, on CPU ranks joined over
gloo (``torch_port_ranks.py``), against the JAX package where it has a
counterpart:

- tensor parallelism splits what the JAX package's
  ``tensor_parallel_params`` splits (linear and convolution kernels, their
  biases, a batchnorm's scale and bias), leaf for leaf, and a split model's
  first-step losses and grads equal the whole model's;
- a tensor-parallel model's checkpoint, weights and export hold the whole
  model: they load into a whole model, ``load_checkpoint(..., mesh=)``
  splits it again bitwise, and a resumed run is bitwise equal to an
  uninterrupted one (the counterpart of ``tests/test_aux_subsystems.py``'s
  round trip);
- a batchnorm VED trains over a ``'data'`` axis with the whole batch's
  statistics, padded tail rows included, as the JAX package's GSPMD step
  takes them on a 2-device mesh.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import pyroved_tpu.models as jmodels
import pyroved_tpu.parallel as jpar
from pyroved_tpu.trainers.svi import SVItrainer as JSVItrainer
from pyroved_tpu.utils.data import init_dataloader as jinit_dataloader
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.serving import ServedModel
from pyroved_tpu_torch.trainers import SVItrainer
from pyroved_tpu_torch.utils.checkpoint import load_checkpoint
from pyroved_tpu_torch.utils.data import init_dataloader
from pyroved_tpu_torch.weights import from_jax_params

from test_torch_port_parallel import DATA, SMALL, _imgs, _state, _svi_noise
from torch_port_ranks import Ranks, build
from torch_port_ranks import params as port_params

# the port's f32 bounds against the JAX package (PERF.md section 2)
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
VED_IO = ((16, 16), (32,))
VED_KW = dict(latent_dim=2, hidden_dim_e=((4,), (8,)),
              hidden_dim_d=((8,), (4,)), batchnorm=True)
CKPT = dict(rows=32, batch=8)
BN = dict(rows=28, batch=8, epochs=2, seed=7)  # the last batch padded


@pytest.fixture(autouse=True, scope="module")
def f32_port():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsd, "BF16_MATMUL", False)
        yield


def _ved(seed=3):
    return jmodels.VED(*VED_IO, seed=seed, **VED_KW)


def _pairs(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n,) + VED_IO[0]).astype(np.float32),
            rng.uniform(0, 1, (n,) + VED_IO[1]).astype(np.float32))


def _split_cases():
    """(JAX model, the body's case) of each model split over 'model'."""
    key = jax.random.PRNGKey(5)
    x, y = _pairs(4, 0)
    w = np.array([1.0, 1.0, 0.5, 0.0], np.float32)
    jv = _ved()
    ji = jmodels.iVAE(DATA, latent_dim=2, invariances=["r"], seed=2, **SMALL)
    return {
        "ved": (jv, dict(cls="VED", args=VED_IO, kw=VED_KW, state=_state(jv),
                         batch=(x, y), beta=1.0, w=w,
                         eps=np.asarray(jax.random.normal(key, (4, 2))))),
        "ivae": (ji, dict(cls="iVAE", args=(DATA, 2, ["r"]), kw=dict(SMALL),
                          state=_state(ji), batch=(_imgs(4, 3),), beta=1.0,
                          w=w, eps=np.asarray(jax.random.normal(key,
                                                                (4, 3))))),
    }


def _bn_case():
    jm = _ved(seed=4)
    x, y = _pairs(BN["rows"], 1)
    steps = -(-BN["rows"] // BN["batch"])
    key = jax.random.PRNGKey(9)
    xb, yb = _pairs(BN["batch"], 2)
    w = np.ones(BN["batch"], np.float32)
    w[-2:] = 0.0  # two padded rows: in the statistics, not in the loss
    first = (xb, yb, w, np.asarray(jax.random.normal(key, (BN["batch"], 2))))
    return jm, key, dict(cls="VED", args=VED_IO, kw=VED_KW, state=_state(jm),
                         first=first, x=(x, y), batch_size=BN["batch"],
                         epochs=BN["epochs"],
                         noise=_svi_noise(BN["seed"], BN["epochs"], steps,
                                          (BN["batch"], 2)))


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("repair_ranks")
    split = _split_cases()
    bn_model, bn_key, bn = _bn_case()
    ckpt_state = _state(jmodels.iVAE(DATA, latent_dim=2, invariances=["r"],
                                     seed=1, **SMALL))
    ckpt = dict(state=ckpt_state, x=_imgs(CKPT["rows"], 5),
                batch_size=CKPT["batch"], tmp=str(tmp))
    ranks = Ranks(tmp, 2, [
        ("split", "tp_split", {"cases": {k: c for k, (_, c) in
                                         split.items()}}),
        ("ckpt", "tp_checkpoint", ckpt),
        ("bn", "bn_dp", bn)])
    return dict(ranks=ranks, split=split, bn=(bn_model, bn_key, bn),
                ckpt=ckpt)


# ---------------------------------------------------------------------------
# F3: what is split, and that a split model computes the same
# ---------------------------------------------------------------------------

def _jax_split_names(jm):
    """The port's names of the leaves the JAX package's
    ``tensor_parallel_params`` shards over a 2-device 'model' axis."""
    mesh = jpar.create_mesh({"model": 2}, jax.devices()[:2])
    placed = jpar.tensor_parallel_params(jm.params, mesh)
    marks = jax.tree_util.tree_map(
        lambda leaf: np.full(leaf.shape, float(
            "model" in str(leaf.sharding.spec)), np.float32), placed)
    return sorted(n for n, t in from_jax_params(marks).items()
                  if t.numel() and bool(t.all()))


@pytest.mark.parametrize("case", ["ved", "ivae"])
def test_tensor_parallel_splits_what_jax_splits(two, case):
    """Leaf for leaf the JAX package's split: the VED's convolutions, their
    biases and its batchnorms' scale and bias too, where 2 divides the
    output features; the 1-channel heads stay whole."""
    jm, _ = two["split"][case]
    res = two["ranks"].get("split")[case]
    assert res["split_params"] == _jax_split_names(jm)
    kinds = {kind for _, kind in res["layers"]}
    assert kinds == ({"ColumnParallelLinear", "ColumnParallelConv",
                      "ColumnParallelBatchNorm"} if case == "ved"
                     else {"ColumnParallelLinear"})


@pytest.mark.parametrize("case", ["ved", "ivae"])
def test_split_model_matches_whole_model(two, case):
    """Per-example losses and every grad of one weighted loss, split over
    'model' on 2 ranks against the whole model, on both ranks (the whole
    model's own parity with the JAX package is the single-device files')."""
    for r in (0, 1):
        res = two["ranks"].get("split", r)[case]
        np.testing.assert_allclose(res["split"]["loss"], res["whole"]["loss"],
                                   rtol=LOSS_RTOL)
        assert sorted(res["split"]["grads"]) == sorted(res["whole"]["grads"])
        for k, g in res["whole"]["grads"].items():
            np.testing.assert_allclose(res["split"]["grads"][k], g,
                                       atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# F1: the files of a tensor-parallel model
# ---------------------------------------------------------------------------

def _whole_model(ckpt):
    return build("iVAE", (DATA, 2, ["r"]), dict(SMALL), ckpt["state"])


def _same(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k


def test_tp_checkpoint_resumes_bitwise(two):
    """Saved mid-run on {'model': 2}: ``load_checkpoint(mesh=)`` gives each
    rank its saved shards bitwise; the resumed run (trainer built on the
    split model, and trainer built on the whole model and moved onto the
    split) equals the uninterrupted one bitwise, history included."""
    outs = two["ranks"].all("ckpt")
    for o in outs:
        assert "decoder.MLP_0.Dense_0.weight" in o["split"]
        _same(o["loaded"], o["saved"])
        _same(o["resumed"], o["uninterrupted"])
        _same(o["resumed_whole_trainer"], o["uninterrupted"])
        assert o["resumed_history"] == o["history"]
    _same(outs[1]["saved_whole"], outs[0]["saved_whole"])
    a, b = outs[0]["saved"], outs[1]["saved"]
    assert not np.array_equal(a["decoder.MLP_0.Dense_0.weight"],
                              b["decoder.MLP_0.Dense_0.weight"])


def test_tp_checkpoint_written_by_rank_zero_alone(two):
    """Every rank calls save_checkpoint (each joins the gathers), each
    with a path of its own here: only global rank 0's file exists, written
    at once and on a thread alike."""
    two["ranks"].all("ckpt")
    tmp = two["ckpt"]["tmp"]
    for mode in (0, 1):
        assert os.path.exists(f"{tmp}/writer0_{mode}.npz")
        assert not os.path.exists(f"{tmp}/writer1_{mode}.npz")


@pytest.mark.parametrize("what", ["grad_accum", "width"])
def test_tp_checkpoint_that_does_not_fit_changes_nothing(two, what):
    """load_checkpoint(..., mesh=) of a file that does not fit (a trainer
    with another grad_accum, a model of another width) raises before the
    split: the model stays whole and unchanged, its optimizer on it."""
    for o in two["ranks"].all("ckpt"):
        assert o["refused"][what] == dict(raised=True, split=False,
                                          unchanged=True,
                                          optimizer_on_model=True)


def test_tp_files_load_into_a_whole_model(two):
    """The checkpoint, the weights and the export a split model wrote hold
    the whole model: a whole model loads each (bitwise the gathered
    parameters), serves them, and trains on from the checkpoint."""
    ckpt = two["ckpt"]
    saved = two["ranks"].get("ckpt")["saved_whole"]
    path = f"{ckpt['tmp']}/tp.npz"
    m = _whole_model(ckpt)
    load_checkpoint(path, m)
    _same(port_params(m), saved)
    w = _whole_model(ckpt)
    w.load_weights(f"{ckpt['tmp']}/tp_weights")
    _same(port_params(w), saved)
    z = torch.as_tensor(np.random.default_rng(0).normal(size=(5, 2)),
                        dtype=torch.float32)
    served = ServedModel(f"{ckpt['tmp']}/tp_export.npz", device="cpu")
    np.testing.assert_allclose(np.asarray(served.decode(z)),
                               np.asarray(m.decode(z)), atol=1e-6)
    t = SVItrainer(m, seed=5)
    assert t.resume(path) == 2
    ld = init_dataloader(torch.from_numpy(ckpt["x"]),
                         batch_size=ckpt["batch_size"], seed=4, device="cpu")
    ld.set_epoch(2)
    loss = t.train(ld)
    assert np.isfinite(loss)
    assert not np.array_equal(port_params(m)["decoder.out.weight"],
                              saved["decoder.out.weight"])


def test_replicate_params_takes_a_split_model(two):
    """replicate_params on a split model: every rank ends with the first
    rank's whole layers (the split ones gathered), still split."""
    outs = two["ranks"].all("ckpt")
    _same(outs[1]["replicated"], outs[0]["replicated"])
    state, rep = two["ckpt"]["state"], outs[0]["replicated"]
    for k in ("encoder_z.fc11.weight", "decoder.out.weight"):  # whole: +0
        assert np.array_equal(rep[k], state[k]), k


# ---------------------------------------------------------------------------
# F2: batchnorm over 'data'
# ---------------------------------------------------------------------------

def _jax_bn_first(jm, key, first):
    """The JAX VED's first-step loss and grads on a 2-device 'data' mesh
    (the batch sharded, the parameters replicated)."""
    mesh = jpar.create_mesh({"data": 2}, jax.devices()[:2])
    xb, yb, w, _ = first
    shard = NamedSharding(mesh, P("data"))
    batch = (jax.device_put(jnp.asarray(xb), shard),
             jax.device_put(jnp.asarray(yb), shard))
    params = jpar.replicate_params(jm.params, mesh)
    wj = jax.device_put(jnp.asarray(w), shard)

    def weighted(p):
        return jnp.sum(jm.loss_fn(p, key, batch, jnp.float32(1.0)) * wj)

    loss, grads = jax.jit(jax.value_and_grad(weighted))(params)
    return float(loss), from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                               grads))


def test_batchnorm_ved_trains_over_data_axis(two):
    """A batchnorm VED on {'data': 2}: the first step's loss and grads and 2
    epochs' losses and parameters against the JAX trainer on a 2-device
    mesh, the padded rows inside the statistics on both."""
    jm, key, c = two["bn"]
    ref_loss, ref_grads = _jax_bn_first(jm, key, c["first"])
    outs = two["ranks"].all("bn")
    for o in outs:
        np.testing.assert_allclose(o["first_loss"], ref_loss, rtol=LOSS_RTOL)
        assert sorted(o["first_grads"]) == sorted(ref_grads)
        for k, g in ref_grads.items():
            np.testing.assert_allclose(o["first_grads"][k], g.numpy(),
                                       atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=k)
    mesh = jpar.create_mesh({"data": 2}, jax.devices()[:2])
    jm.params = jpar.replicate_params(jm.params, mesh)
    jt = JSVItrainer(jm, seed=BN["seed"], mesh=mesh)
    ld = jinit_dataloader(*c["x"], batch_size=BN["batch"], seed=3)
    ref = [jt.train(ld) for _ in range(BN["epochs"])]
    for o in outs:
        np.testing.assert_allclose(o["losses"], ref, rtol=LOSS_RTOL)
        for k, v in _state(jm).items():
            np.testing.assert_allclose(o["params"][k], v, atol=GRAD_ATOL,
                                       err_msg=k)
    _same(outs[1]["params"], outs[0]["params"])
