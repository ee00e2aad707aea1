"""The port's parallel layer (``pyroved_tpu_torch/parallel``) on CPU ranks
joined over gloo, against the JAX package's mesh of the same size on the
8 virtual CPU devices: data parallelism through both trainers (``train``,
``run``, ``grad_accum``, jiVAE, ssiVAE with ``auxSVItrainer``, a resumed
run), data x tensor parallelism and its kernel gate, the explicit SPMD
step, ``pixel_sharded_decode``, ``create_mesh``, ``replicate_params`` and
``initialize_multihost``.

The ranks run in child processes (``torch_port_ranks.py``, which imports
nothing of JAX) on the weights, batches and noise this process builds:
each trainer takes the JAX trainer's noise, so the losses agree too. The
port's hidden products are f32 (its flag cleared) but in one case; on the
JAX side the Pallas kernel runs in interpret mode where the port's case is
its kernels' path."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import pyroved_tpu.models as jmodels
import pyroved_tpu.ops.spatial_decoder as sd
import pyroved_tpu.parallel as jpar
from pyroved_tpu.trainers.auxsvi import auxSVItrainer as JauxSVItrainer
from pyroved_tpu.trainers.svi import SVItrainer as JSVItrainer
from pyroved_tpu.utils.data import init_dataloader as jinit_dataloader
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.parallel import create_mesh, data_parallel_mesh
from pyroved_tpu_torch.trainers import SVItrainer
from pyroved_tpu_torch.utils.data import init_dataloader
from pyroved_tpu_torch.weights import from_jax_params

from torch_port_ranks import (FedNoiseAux, FedNoiseSVI, Ranks, build,
                              one_rank_mesh, surface_run)
from torch_port_ranks import params as port_params

# f32 on both sides, the batch's sums split over ranks (devices) in
# another order: per-epoch losses relative, parameters after the run as
# the JAX package's own DP test holds them (tests/test_parallel.py)
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
# DP x TP: the JAX package's own bounds for it (tests/test_parallel.py:
# 88-104), the column-split products summing in yet another order
TP_LOSS_RTOL, TP_PARAM_ATOL = 1e-4, 2e-5
DATA = (8, 8)
SMALL = dict(hidden_dim_e=(32,), hidden_dim_d=(32,))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def f32_port():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsd, "BF16_MATMUL", False)
        yield


def _imgs(n, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n,) + DATA).astype(
        np.float32)


def _state(jm):
    return {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, jm.params)).items()}


def _svi_noise(seed, epochs, steps, shape):
    """The JAX trainers' noise as the port's trainers draw it: a key per
    epoch split from ``PRNGKey(seed)``, ``fold_in(key, step)`` per step."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(epochs):
        key, ek = jax.random.split(key)
        out.append(np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(ek, s), shape)) for s in range(steps)]))
    return np.stack(out)


def _aux_noise(seed, epochs, steps, shape_u, shape_l):
    """auxSVItrainer's: ``fold_in(key, 2i)`` for unlabeled step i,
    ``2i + 1`` for the labeled step after it."""
    key, unl, lab = jax.random.PRNGKey(seed), [], []
    for _ in range(epochs):
        key, ek = jax.random.split(key)
        unl.append(np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(ek, 2 * i), shape_u)) for i in range(steps)]))
        lab.append(np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(ek, 2 * i + 1), shape_l))
            for i in range(steps)]))
    return np.stack(unl), np.stack(lab)


def _jmesh(n):
    return jpar.create_mesh({"data": n}, jax.devices()[:n])


def _close_params(got, ref, atol=PARAM_ATOL):
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=atol, err_msg=k)


def _same_on_ranks(outs, key="params"):
    """Every rank holds bitwise the same parameters."""
    for o in outs[1:]:
        for k, v in outs[0][key].items():
            assert np.array_equal(o[key][k], v), k


# ---------------------------------------------------------------------------
# The 2-rank cases: their inputs, and the ranks started once per module
# ---------------------------------------------------------------------------

def _ivae(seed):
    return jmodels.iVAE(DATA, latent_dim=2, invariances=["r"], seed=seed,
                        **SMALL)


TRAIN = {  # key: (jax model seed, rows, batch, loader seed, epochs, how)
    "dp_kernels": (5, 64, 16, 2, 1, "train"),
    "dp_module": (5, 64, 16, 2, 1, "train"),
    "run2": (3, 32, 8, 6, 2, "run"),
    "run8": (3, 32, 8, 6, 8, "run"),
    "accum": (5, 64, 16, 2, 2, "train"),
    "one_pass": (5, 64, 16, 2, 1, "train"),
    "uneven": (7, 45, 15, 1, 2, "train"),
    "bf16": (5, 64, 16, 2, 1, "train"),
    "resume_whole": (9, 32, 8, 3, 4, "run"),
    "resume_split": (9, 32, 8, 3, 4, "resume"),
}
AUX = dict(rows=40, labeled=10, batch=10, epochs=2, seed=3)


def _train_case(key, tmp):
    seed, n, bs, lseed, epochs, how = TRAIN[key]
    jm = _ivae(seed)
    steps = -(-n // bs)
    kw = dict(SMALL, fused=key != "dp_module")
    if key == "one_pass":
        kw["one_pass_train"] = True
    return jm, dict(cls="iVAE", args=(DATA, 2, ["r"]), kw=kw,
                    state=_state(jm), x=(_imgs(n, seed),), batch_size=bs,
                    seed=lseed, epochs=epochs, how=how,
                    noise=_svi_noise(seed, epochs, steps, (bs, 3)),
                    bf16=key == "bf16",
                    trainer_kw={"grad_accum": 2} if key == "accum" else None,
                    ckpt=str(tmp / "state.npz") if how == "resume" else None)


JIVAE_SEED = 6


def _jivae_case():
    jm = jmodels.jiVAE(DATA, 2, 3, ["r"], seed=JIVAE_SEED, **SMALL)
    return jm, dict(cls="jiVAE", args=(DATA, 2, 3, ["r"]), kw=dict(SMALL),
                    state=_state(jm), x=(_imgs(32, 6),), batch_size=8,
                    seed=1, epochs=1,
                    noise=_svi_noise(JIVAE_SEED, 1, 4, (8, 3)))


def _aux_case():
    jm = jmodels.ssiVAE(DATA, 2, 3, ["r"], seed=4, **SMALL)
    xu, xl = _imgs(AUX["rows"], 11), _imgs(AUX["labeled"], 12)
    yl = np.eye(3, dtype=np.float32)[np.arange(AUX["labeled"]) % 3]
    bs = AUX["batch"]
    steps = AUX["rows"] // bs
    unl, lab = _aux_noise(AUX["seed"], AUX["epochs"], steps, (3, bs, 3),
                          (bs // 2, 3))
    return jm, dict(args=(DATA, 2, 3, ["r"]), kw=dict(SMALL),
                    state=_state(jm), xu=xu, xl=xl, yl=yl, batch_size=bs,
                    unl=unl, lab=lab, epochs=AUX["epochs"])


def _spmd_case():
    jm = jmodels.iVAE(DATA, latent_dim=2, invariances=["r"], seed=0)
    x = _imgs(32, 0)
    rng = jax.random.PRNGKey(0)
    # the JAX step folds its key by the shard's index: shard i of step k
    # draws normal(fold_in(fold_in(rng, k), i)) for its 16 rows
    eps = [[np.asarray(jax.random.normal(jax.random.fold_in(
        jax.random.fold_in(rng, k), i), (16, 3))) for i in range(2)]
        for k in range(5)]
    return jm, dict(state=_state(jm), x=x, w=np.ones(32, np.float32),
                    eps=eps, steps=5)


SURFACE = dict(rows=32, held_out=16, batch=8, epochs=4)


def _surface_case(tmp):
    """The trainer surface's inputs; its noise is random (the reference is
    the port on one rank, which the single-device files hold to JAX)."""
    rng = np.random.default_rng(8)
    steps = SURFACE["rows"] // SURFACE["batch"]
    # run's epochs train and evaluate, then evaluate, then step's two
    rows = 2 * SURFACE["epochs"] + 3
    return dict(state=_state(_ivae(8)), x=_imgs(SURFACE["rows"], 8),
                xt=_imgs(SURFACE["held_out"], 9),
                noise=rng.normal(size=(rows, steps, SURFACE["batch"], 3))
                .astype(np.float32), batch_size=SURFACE["batch"],
                epochs=SURFACE["epochs"], log=str(tmp / "surface.jsonl"),
                jstate=_state(jmodels.jiVAE(DATA, 2, 3, ["r"], enum_topk=2,
                                            seed=8, **SMALL)),
                jnoise=rng.normal(size=(2, steps, SURFACE["batch"], 3))
                .astype(np.float32))


DECODE = {"even": (8, 16), "padded": (9, 9)}  # 128 pixels; 81 over 2


def _decode_cases():
    out = {}
    for name, data in DECODE.items():
        jm = jmodels.iVAE(data, latent_dim=2, invariances=["r"], seed=1)
        z = np.random.default_rng(0).normal(size=(4, 2)).astype(np.float32)
        for fused in (True, False):
            out[f"{name}_{'kernels' if fused else 'module'}"] = (
                data, _state(jm), z, fused)
    return out


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """Every 2-rank case, run once by the module's ranks; the cases' JAX
    models ride along for the references."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    models, bodies = {}, [("world", "world", {})]
    for key in TRAIN:
        models[key], kw = _train_case(key, tmp)
        bodies.append((key, "train", kw))
    models["jivae"], kw = _jivae_case()
    bodies.append(("jivae", "train", kw))
    models["aux"], kw = _aux_case()
    bodies.append(("aux", "aux", kw))
    models["spmd"], kw = _spmd_case()
    bodies.append(("spmd", "spmd", kw))
    bodies.append(("decode", "decode", {"cases": _decode_cases()}))
    bodies.append(("replicate", "replicate", {}))
    bodies.append(("surface", "surface", _surface_case(tmp)))
    ranks = Ranks(tmp, 2, bodies)
    return ranks, models, dict((k, kw) for k, _, kw in bodies)


def _port_one_rank(kw):
    """The same case in this process, without a mesh."""
    m = build(kw["cls"], kw["args"], kw["kw"], kw["state"])
    t = FedNoiseSVI(m, kw["noise"], **(kw.get("trainer_kw") or {}))
    ld = init_dataloader(torch.from_numpy(kw["x"][0]),
                         batch_size=kw["batch_size"], seed=kw["seed"],
                         device="cpu")
    losses = ([t.train(ld) for _ in range(kw["epochs"])]
              if kw.get("how", "train") == "train" else t.run(ld, kw["epochs"]))
    return losses, port_params(m)


def _jax_dp(jm, kw, seed, fused=False, trainer_kw=None):
    """The JAX trainer (noise seed ``seed``) on a 2-device 'data' mesh:
    (losses, parameters)."""
    mesh = _jmesh(2)
    jm.params = jpar.replicate_params(jm.params, mesh)
    if fused:
        jm._fused = True
    jt = JSVItrainer(jm, seed=seed, mesh=mesh, **(trainer_kw or {}))
    ld = jinit_dataloader(kw["x"][0], batch_size=kw["batch_size"],
                          seed=kw["seed"])
    if kw.get("how", "train") == "train":
        losses = [jt.train(ld) for _ in range(kw["epochs"])]
    else:
        losses = jt.run(ld, kw["epochs"])
    return np.asarray(losses), _state(jm)


def _check_dp(two, key, fused=False, trainer_kw=None):
    """A 2-rank case against the JAX trainer on 2 devices and against the
    port on one rank; the ranks' parameters bitwise equal."""
    ranks, models, spec = two
    kw = spec[key]
    seed = TRAIN[key][0] if key in TRAIN else JIVAE_SEED
    ref_losses, ref_params = _jax_dp(models[key], kw, seed, fused,
                                     trainer_kw)
    outs = ranks.all(key)
    _same_on_ranks(outs)
    np.testing.assert_allclose(outs[0]["losses"], ref_losses, rtol=LOSS_RTOL)
    _close_params(outs[0]["params"], ref_params)
    one_losses, one_params = _port_one_rank(kw)
    np.testing.assert_allclose(outs[0]["losses"], one_losses, rtol=LOSS_RTOL)
    _close_params(outs[0]["params"], one_params)
    return outs


# ---------------------------------------------------------------------------
# Start-up and meshes
# ---------------------------------------------------------------------------

def test_initialize_multihost_returns_the_world_size(two):
    """The cheap counterpart of the JAX package's gated two-process
    loopback test: two processes meet at a file:// rendezvous, each gets
    2, and data_parallel_mesh spans them."""
    for r, out in enumerate(two[0].all("world")):
        assert out == {"world": 2, "rank": r, "mesh": {"data": 2},
                       "local": r}


def test_create_mesh_shapes_on_four_ranks(four):
    """tests/test_parallel.py:27-33 on a 4-rank world."""
    ref = {"dp_tp": dict(jpar.create_mesh({"data": 2, "model": 2},
                                          jax.devices()[:4]).shape),
           "absorb": dict(jpar.create_mesh({"data": -1, "model": 2},
                                           jax.devices()[:4]).shape)}
    with pytest.raises(ValueError):
        jpar.create_mesh({"data": 3}, jax.devices()[:4])
    outs = four.all("mesh")
    for r, out in enumerate(outs):
        assert out["dp_tp"] == ref["dp_tp"] == {"data": 2, "model": 2}
        assert out["absorb"] == ref["absorb"]
        assert out["dp_tp_coord"] == (r // 2, r % 2)
        assert "do not cover 4 ranks" in out["error"]


def test_meshes_need_a_group_and_trainers_a_device_mesh():
    """Without a process group create_mesh raises; a mesh that is not a
    DeviceMesh is a TypeError naming it; a one-rank world (its own store)
    gives a one-rank mesh that trains as one device does."""
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        create_mesh({"data": 1})
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        data_parallel_mesh()
    kw = _train_case("dp_kernels", None)[1]
    m = build(kw["cls"], kw["args"], kw["kw"], kw["state"])
    with pytest.raises(TypeError, match="DeviceMesh"):
        SVItrainer(m, mesh=object())
    ref, _ = _port_one_rank(kw)
    with one_rank_mesh() as mesh:
        assert dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)) == {"data": 1}
        t = FedNoiseSVI(m, kw["noise"], mesh=mesh)
        assert t.mesh is mesh and t.data_axis.size == 1
        ld = init_dataloader(torch.from_numpy(kw["x"][0]), batch_size=16,
                             seed=2, device="cpu")
        assert [t.train(ld)] == ref  # one rank: bitwise the single device


def test_replicate_params_broadcasts_rank_zero(two):
    outs = two[0].all("replicate")
    for k, v in outs[0]["before"].items():
        assert not np.array_equal(outs[1]["before"][k], v)
        for o in outs:
            assert np.array_equal(o["after"][k], v)


# ---------------------------------------------------------------------------
# Data parallelism
# ---------------------------------------------------------------------------

def test_dp_epoch_on_the_kernels_path_matches_jax_fused(two, monkeypatch):
    """tests/test_parallel.py:36-52 and :118-137: the port's kernels' path
    (their plain versions here, one K1 and one K2 a step on each rank's 8
    rows) against the JAX package's fused kernel in interpret mode under
    GSPMD, and against the port on one rank."""
    monkeypatch.setattr(sd, "INTERPRET", True)
    monkeypatch.setattr(sd, "BF16_MATMUL", False)
    monkeypatch.setattr(sd, "FUSED_MIN_BNH", 0)
    outs = _check_dp(two, "dp_kernels", fused=True)
    assert outs[0]["fused"] and outs[0]["calls"] == {"K1": 4, "K2": 4,
                                                     "K3": 0}


def test_dp_epoch_on_the_module_path_matches_jax(two):
    outs = _check_dp(two, "dp_module")
    assert not outs[0]["fused"] and outs[0]["calls"]["K1"] == 0


@pytest.mark.parametrize("key", ["run2", "run8"])
def test_dp_run_matches_jax(two, key):
    """tests/test_parallel.py:181-198 (2 epochs) and :236-255 (8, over
    the JAX package's pipelined segments)."""
    _check_dp(two, key)


def test_dp_grad_accum_matches_jax(two):
    """tests/test_parallel.py:258-277: each micro-step's grads summed over
    the ranks before they enter the window."""
    _check_dp(two, "accum", trainer_kw={"grad_accum": 2})


def test_dp_one_pass_train_matches_jax(two):
    """``one_pass_train=True`` under a mesh (the JAX package's gate does not
    exclude one): one K3 a step on each rank's 8 rows and nothing else."""
    outs = _check_dp(two, "one_pass")
    assert outs[0]["calls"] == {"K1": 0, "K2": 0, "K3": 4}


def test_dp_trainer_surface_matches_one_rank(two, tmp_path):
    """run with a held-out loader, patience, on_segment, a JSONL log and
    remat, then evaluate, step and print_statistics, and jiVAE's
    enum_schedule, on 2 ranks against one: the same histories, records
    and parameters; the log written and the statistics printed once, by
    rank 0."""
    ranks, _, spec = two
    kw = dict(spec["surface"], log=str(tmp_path / "one.jsonl"))
    ref = surface_run(None, **kw)
    outs = ranks.all("surface")
    for key in ("params", "enum_params"):
        _same_on_ranks(outs, key)
        _close_params(outs[0][key], ref[key])
    for name in ("training_loss", "test_loss"):
        np.testing.assert_allclose(outs[0]["history"][name],
                                   ref["history"][name], rtol=LOSS_RTOL)
    np.testing.assert_allclose(outs[0]["evaluate"], ref["evaluate"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(outs[0]["enum"], ref["enum"], rtol=LOSS_RTOL)
    assert outs[0]["epoch"] == outs[1]["epoch"] == ref["epoch"]
    assert [r["epoch"] for r in outs[0]["records"]] == [
        r["epoch"] for r in ref["records"]]
    assert outs[0]["printed"] == ref["printed"] and outs[1]["printed"] == ""
    lines = open(spec["surface"]["log"]).read().splitlines()
    assert len(lines) == len(open(kw["log"]).read().splitlines()) == \
        ref["epoch"]


def test_dp_uneven_rows_match_one_rank(two):
    """Batches of 15 rows split 8 / 7 (tensor_split): the same trajectory
    as one rank."""
    ranks, _, spec = two
    outs = ranks.all("uneven")
    _same_on_ranks(outs)
    losses, ref = _port_one_rank(spec["uneven"])
    np.testing.assert_allclose(outs[0]["losses"], losses, rtol=LOSS_RTOL)
    _close_params(outs[0]["params"], ref)


def test_dp_jivae_epoch_matches_jax(two):
    _check_dp(two, "jivae")


def test_dp_aux_trainer_ssivae_matches_jax(two):
    """auxSVItrainer with ssiVAE on 2 ranks: the unlabeled steps (3
    enumerated classes) and the labeled ones with their auxiliary step,
    against the JAX trainer on a 2-device mesh."""
    ranks, models, spec = two
    kw = spec["aux"]
    jm = models["aux"]
    mesh = _jmesh(2)
    jm.params = jpar.replicate_params(jm.params, mesh)
    jt = JauxSVItrainer(jm, seed=AUX["seed"], mesh=mesh)
    lu = jinit_dataloader(kw["xu"], batch_size=kw["batch_size"], seed=1)
    ls = jinit_dataloader(kw["xl"], kw["yl"],
                          batch_size=kw["batch_size"] // 2, seed=2)
    ref = jt.run(lu, ls, kw["epochs"])
    outs = ranks.all("aux")
    _same_on_ranks(outs)
    np.testing.assert_allclose(outs[0]["losses"], ref, rtol=LOSS_RTOL)
    _close_params(outs[0]["params"], _state(jm))
    # and the port on one rank
    m = build("ssiVAE", kw["args"], kw["kw"], kw["state"])
    t = FedNoiseAux(m, kw["unl"], kw["lab"], seed=3)
    one = t.run(init_dataloader(torch.from_numpy(kw["xu"]), batch_size=10,
                                seed=1, device="cpu"),
                init_dataloader(torch.from_numpy(kw["xl"]),
                                torch.from_numpy(kw["yl"]), batch_size=5,
                                seed=2, device="cpu"), kw["epochs"])
    np.testing.assert_allclose(outs[0]["losses"], one, rtol=LOSS_RTOL)
    _close_params(outs[0]["params"], port_params(m))


def test_dp_resumed_run_is_bitwise_uninterrupted(two):
    """4 epochs in one go against 2, a checkpoint (rank 0 writes, both
    wait), a fresh model and trainer on each rank resumed from it and 2
    more: bitwise, on both ranks."""
    ranks = two[0]
    whole, split = ranks.all("resume_whole"), ranks.all("resume_split")
    for w, s in zip(whole, split):
        assert w["losses"] == s["losses"]
        for k, v in w["params"].items():
            assert np.array_equal(s["params"][k], v), k


def test_dp_bf16_matches_one_rank(two):
    """Under BF16_MATMUL (the port's default) the 2-rank epoch against the
    same epoch on one rank, both in bf16: the rows' products round the
    same operands, the sums split in another order."""
    ranks, _, spec = two
    outs = ranks.all("bf16")
    _same_on_ranks(outs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsd, "BF16_MATMUL", True)
        losses, ref = _port_one_rank(spec["bf16"])
    np.testing.assert_allclose(outs[0]["losses"], losses, rtol=LOSS_RTOL)
    _close_params(outs[0]["params"], ref)


# ---------------------------------------------------------------------------
# The explicit SPMD step, pixel_sharded_decode
# ---------------------------------------------------------------------------

def test_spmd_step_matches_jax_with_its_folded_noise(two):
    """tests/test_parallel.py:140-164: one step on 2 ranks, each on its 16
    rows with the JAX step's per-shard noise injected, against JAX's
    shard_map step on 2 devices: the summed loss and the parameters; then
    5 steps."""
    ranks, models, spec = two
    jm = models["spmd"]
    opt = optax.adam(1e-3)
    step = jpar.make_spmd_train_step(jm, opt, _jmesh(2))
    p, s = jm.params, opt.init(jm.params)
    x, w = jnp.asarray(spec["spmd"]["x"]), jnp.ones(32)
    losses, after1 = [], None
    for k in range(5):
        p, s, loss = step(p, s, jax.random.fold_in(jax.random.PRNGKey(0), k),
                          (x,), w, jnp.float32(1.0))
        losses.append(float(loss))
        if k == 0:
            after1 = {n: v.numpy() for n, v in from_jax_params(
                jax.tree_util.tree_map(np.asarray, p)).items()}
    outs = ranks.all("spmd")
    _same_on_ranks([o["fed"] for o in outs])
    np.testing.assert_allclose(outs[0]["fed"]["losses"], losses,
                               rtol=LOSS_RTOL)
    _close_params(outs[0]["fed"]["after1"], after1)
    _close_params(outs[0]["fed"]["params"], {
        n: v.numpy() for n, v in from_jax_params(
            jax.tree_util.tree_map(np.asarray, p)).items()})


def test_spmd_step_with_its_own_noise_trains(two):
    """tests/test_parallel.py:210-233: each rank's noise from its own
    generator; the loss falls over 5 steps and the ranks' parameters stay
    bitwise equal. A batch that does not divide over the ranks raises."""
    outs = two[0].all("spmd")
    own = [o["own"] for o in outs]
    _same_on_ranks(own)
    assert own[0]["losses"] == own[1]["losses"]
    assert all(np.isfinite(own[0]["losses"]))
    assert own[0]["losses"][-1] < own[0]["losses"][0]
    assert "do not divide" in outs[0]["uneven"]


@pytest.mark.parametrize("case", ["even_kernels", "even_module",
                                  "padded_kernels", "padded_module"])
def test_pixel_sharded_decode_matches_local(two, case):
    """tests/test_parallel.py:74-85: each rank decodes its slice of the
    grid (padded when 2 does not divide it) and the slices are gathered,
    against the model's own decode and the JAX package's sharded decode on
    2 devices; a model without invariances raises."""
    ranks, _, spec = two
    data, state, z, _ = spec["decode"]["cases"][case]
    jm = jmodels.iVAE(data, latent_dim=2, invariances=["r"], seed=1)
    mesh = _jmesh(2) if data[0] * data[1] % 2 == 0 else None
    for out in ranks.all("decode"):
        got = out[case]
        np.testing.assert_allclose(got["sharded"], got["local"], atol=1e-5)
        if mesh is not None:
            ref = jpar.pixel_sharded_decode(jm, jnp.asarray(z), mesh)
            np.testing.assert_allclose(got["sharded"], np.asarray(ref),
                                       atol=1e-5)
        assert "spatial decoder" in out["error"]


# ---------------------------------------------------------------------------
# Data x tensor parallelism on 4 ranks
# ---------------------------------------------------------------------------

TP_SEED, TP_ROWS, TP_BATCH, TP_LOADER = 11, 32, 8, 4


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    jm = jmodels.iVAE(DATA, latent_dim=2, invariances=["r"], seed=TP_SEED)
    kw = dict(state=_state(jm), x=_imgs(TP_ROWS, 1),
              noise=_svi_noise(TP_SEED, 1, TP_ROWS // TP_BATCH,
                               (TP_BATCH, 3)),
              batch_size=TP_BATCH, seed=TP_LOADER)
    ranks = Ranks(tmp_path_factory.mktemp("four_ranks"), 4,
                  [("mesh", "mesh_shapes", {}), ("tp", "tp", kw)])
    ranks.jax_model, ranks.kw = jm, kw
    return ranks


def _whole(outs):
    """Each parameter whole from data rank 0's 'model' ranks (global ranks
    0 and 1): a split layer's shards joined on the weight's first dim, a
    whole one bitwise equal on both."""
    a, b = outs[0]["params"], outs[1]["params"]
    out = {}
    for k, v in a.items():
        if any(k.startswith(m + ".") for m in outs[0]["split"]):
            out[k] = np.concatenate([v, b[k]])
        else:
            assert np.array_equal(v, b[k]), k
            out[k] = v
    return out


def test_dp_tp_training_matches_jax(four):
    """tests/test_parallel.py:88-104: {'data': 2, 'model': 2} on 4 ranks
    against the JAX package's on 4 devices (its tolerances)."""
    jm, kw = four.jax_model, four.kw
    mesh = jpar.create_mesh({"data": 2, "model": 2}, jax.devices()[:4])
    jm.params = jpar.tensor_parallel_params(jm.params, mesh)
    jt = JSVItrainer(jm, seed=TP_SEED, mesh=mesh)
    ref = jt.train(jinit_dataloader(kw["x"], batch_size=TP_BATCH,
                                    seed=TP_LOADER))
    outs = four.all("tp")
    for o in outs:
        np.testing.assert_allclose(o["loss"], ref, rtol=TP_LOSS_RTOL)
    for r in (0, 1):  # rank r and r + 2: one shard, two data ranks
        for k, v in outs[r]["params"].items():
            assert np.array_equal(outs[r + 2]["params"][k], v), k
    _close_params(_whole(outs), _state(jm), atol=TP_PARAM_ATOL)


def test_tensor_parallel_placement(four):
    """tests/test_parallel.py:64-71: a 128-wide layer is split over
    'model' (torch weight dim 0, the JAX kernel's last axis); a layer
    whose width 2 does not divide (the 1-channel head, the 3 latents)
    stays whole."""
    jparams = jpar.tensor_parallel_params(
        four.jax_model.params,
        jpar.create_mesh({"data": 2, "model": 2}, jax.devices()[:4]))
    k = jparams["decoder"]["MLP_0"]["Dense_0"]["kernel"]
    assert "model" in str(k.sharding.spec)
    for o in four.all("tp"):
        assert o["dense0"] == ("ColumnParallelLinear", (64, 128))
        assert o["out"] == ("Dense", (1, 128))
        assert "encoder_z.fc11" not in o["split"]
        assert "decoder.MLP_0.Dense_0" in o["split"]


def test_tp_decoder_turns_the_kernels_off(four):
    """tests/test_parallel.py:167-178: a decoder split over 'model' turns
    the kernels off at the first train call, with the warning, and no
    kernel runs."""
    for o in four.all("tp"):
        assert o["fused_before"] and not o["fused_after"]
        assert any("disabling the fused" in w for w in o["warnings"])
        assert o["calls"] == {"K1": 0, "K2": 0, "K3": 0}
