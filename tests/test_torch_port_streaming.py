"""The port's streaming input paths: ``DataLoader(device_resident=False)``
per batch and in chunks (``stream_chunks``), ``prefetch``, iterables of
batches, ``pyroved_tpu_torch.native`` (``gather_rows``, ``u8_to_f32``,
``BatchPipeline``), narrow storage (``store_dtype``) and ``scale``.

In the port a streamed epoch draws the same noise in the same order as a
resident one and feeds the model the same rows, so it is bitwise equal to
the resident epoch; that is held here under each ``BF16_MATMUL`` setting,
for ``SVItrainer`` and ``auxSVItrainer``. Against the JAX package's
streaming trainers (its noise injected) the losses and parameters agree
within the f32 tolerances of ``PERF.md`` section 2; the stored narrow
arrays and the native helpers' outputs are bitwise the JAX package's."""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax

import pyroved_tpu.models as jmodels
from pyroved_tpu import native as jnative
from pyroved_tpu.trainers.auxsvi import auxSVItrainer as JauxSVItrainer
from pyroved_tpu.trainers.svi import SVItrainer as JSVItrainer
from pyroved_tpu.utils.data import DataLoader as JDataLoader
import pyroved_tpu_torch.models as tmodels
from pyroved_tpu_torch import native
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.trainers import SVItrainer, auxSVItrainer
from pyroved_tpu_torch.utils.data import (DataLoader, prefetch,
                                          shuffle_indices)
from pyroved_tpu_torch.utils.nn import as_numpy
from pyroved_tpu_torch.weights import from_jax_params

from test_torch_port_segmented import JaxNoiseAux, JaxNoiseSVI

# Losses: the JAX trainer's compiled steps against the port's eager ones,
# f32 on both sides; parameters after a few Adam steps: the port's
# acceptance bound (PERF.md section 2)
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-4, 1e-3
DATA = (12, 12)
SMALL = dict(hidden_dim_e=(32,), hidden_dim_d=(32,))
N, BS, SEED = 40, 16, 3  # three batches, the last one of 8 rows


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: these small models run faster
    so, and the suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def f32_port(monkeypatch):
    """f32 by default, as every port test with a JAX side; the bitwise
    tests set the flag themselves."""
    monkeypatch.setattr(tsd, "BF16_MATMUL", False)


def _x(n=N, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n,) + DATA).astype(
        np.float32)


def _params(model):
    return [p.detach().clone() for p in model.nets.parameters()]


def _bitwise(a, b):
    assert len(a) == len(b)
    for p, q in zip(a, b):
        assert torch.equal(p, q)


def _epoch_batches(X, epoch, rows=None):
    """One epoch of the resident loader's batches (seed SEED) as numpy
    tuples; the last batch short."""
    perm = shuffle_indices(X.shape[0], SEED, epoch)
    return [tuple(a[perm[i:i + BS]] for a in ((X,) if rows is None else rows))
            for i in range(0, X.shape[0], BS)]


# Each way to stream an epoch of X: a function of (X, epoch) giving what
# SVItrainer.train takes
PATHS = {
    "per_batch": lambda X, e: _loader(X, e, device_resident=False),
    "chunked": lambda X, e: _loader(X, e, device_resident=False,
                                    stream_chunks=2),
    "prefetch": lambda X, e: prefetch(_loader(X, e, device_resident=False)),
    "iterable": lambda X, e: iter(_epoch_batches(X, e)),
}


def _loader(X, epoch, **kw):
    ld = DataLoader(X, batch_size=BS, seed=SEED, device="cpu", **kw)
    ld.set_epoch(epoch)
    return ld


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("path", sorted(PATHS) + ["pipeline"])
def test_streamed_epochs_are_bitwise_resident_epochs(path, bf16, monkeypatch):
    """Two epochs of iVAE through each streaming path against the resident
    loader: per-epoch losses and parameters bit for bit (the short last
    batch padded with zero rows instead of row 0, both of weight 0)."""
    monkeypatch.setattr(tsd, "BF16_MATMUL", bf16)
    X = _x()
    out = []
    for kind in ("resident", path):
        m = tmodels.iVAE(DATA, invariances=["r"], device="cpu", seed=2,
                         **SMALL)
        t = SVItrainer(m, seed=5)
        if kind == "pipeline":
            with native.BatchPipeline(X, BS, seed=SEED) as pipe:
                losses = [t.train(pipe.epoch_batches()) for _ in range(2)]
        elif kind == "resident":
            ld = _loader(X, 0)
            losses = [t.train(ld) for _ in range(2)]
        else:
            losses = [t.train(PATHS[kind](X, e)) for e in range(2)]
        out.append((losses, _params(m)))
    assert out[1][0] == out[0][0]
    _bitwise(out[1][1], out[0][1])


@pytest.mark.parametrize("chunks", [0, 2], ids=["per_batch", "chunked"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_aux_streamed_epochs_are_bitwise_resident_epochs(chunks, bf16,
                                                         monkeypatch):
    """ssiVAE: a streaming unlabeled loader, and a streaming labeled one,
    against resident loaders; and iterables of the same batches, with
    ``sup_period``: losses and parameters bit for bit."""
    monkeypatch.setattr(tsd, "BF16_MATMUL", bf16)
    xu, xl = _x(48, 1), _x(16, 2)
    yl = np.eye(3, dtype=np.float32)[np.arange(16) % 3]

    def run(stream_u, stream_s, iterable=False):
        m = tmodels.ssiVAE(DATA, 2, 3, ["r"], device="cpu", seed=1, **SMALL)
        t = auxSVItrainer(m, seed=7)
        losses = []
        for e in range(2):
            lu = DataLoader(xu, batch_size=BS, seed=SEED, device="cpu",
                            device_resident=not stream_u,
                            stream_chunks=chunks)
            ls = DataLoader(xl, yl, batch_size=8, seed=4, device="cpu",
                            device_resident=not stream_s)
            lu.set_epoch(e)
            ls.set_epoch(e)
            if iterable:  # the same batches, in the same order
                perm = shuffle_indices(16, 4, e)
                sup = [(xl[perm[i:i + 8]], yl[perm[i:i + 8]])
                       for i in (0, 8)]
                losses.append(t.train(iter(_epoch_batches(xu, e)), sup,
                                      sup_period=2))
            else:
                losses.append(t.train(lu, ls))
        return losses, _params(m)

    ref = run(False, False)
    for got in (run(True, False), run(True, True), run(False, True),
                run(True, True, iterable=True)):
        assert got[0] == ref[0]
        _bitwise(got[1], ref[1])


def _check_params(tm, jm):
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    for name, p in tm.nets.named_parameters():
        np.testing.assert_allclose(as_numpy(p), ref[name].numpy(),
                                   atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("chunks", [0, 2], ids=["per_batch", "chunked"])
def test_streaming_trainers_match_jax(chunks):
    """Two streamed epochs of iVAE (and a streamed held-out evaluation)
    through the JAX trainer's streaming paths and the port's, the JAX
    noise injected."""
    X, Xt = _x(), _x(24, 5)
    jm = jmodels.iVAE(DATA, invariances=["r"], seed=3, **SMALL)
    tm = tmodels.iVAE(DATA, invariances=["r"], device="cpu", **SMALL)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    jt, tt = JSVItrainer(jm, seed=9), JaxNoiseSVI(tm, 9)
    jl = JDataLoader(X, batch_size=BS, seed=SEED, device_resident=False,
                     stream_chunks=chunks)
    tl = DataLoader(X, batch_size=BS, seed=SEED, device_resident=False,
                    stream_chunks=chunks, device="cpu")
    for _ in range(2):
        np.testing.assert_allclose(tt.train(tl), jt.train(jl),
                                   rtol=LOSS_RTOL)
    np.testing.assert_allclose(
        tt.evaluate(DataLoader(Xt, batch_size=BS, device_resident=False,
                               device="cpu")),
        jt.evaluate(JDataLoader(Xt, batch_size=BS, device_resident=False)),
        rtol=LOSS_RTOL)
    _check_params(tm, jm)


@pytest.mark.parametrize("chunks", [0, 2], ids=["per_batch", "chunked"])
def test_aux_streaming_matches_jax(chunks):
    """ssiVAE with a streamed unlabeled loader (three batches, one labeled
    step an epoch, so JAX's per-batch path, which iterates the labeled
    loader, takes the batch of the resident schedule) through both
    packages' streaming paths, the JAX noise injected."""
    xu, xl = _x(48, 1), _x(32, 2)
    yl = np.eye(3, dtype=np.float32)[np.arange(32) % 3]
    jm = jmodels.ssiVAE(DATA, 2, 3, ["r"], seed=4, **SMALL)
    tm = tmodels.ssiVAE(DATA, 2, 3, ["r"], device="cpu", **SMALL)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    jt, tt = JauxSVItrainer(jm, seed=2), JaxNoiseAux(tm, 2)
    jlu = JDataLoader(xu, batch_size=BS, seed=1, device_resident=False,
                      stream_chunks=chunks)
    jls = JDataLoader(xl, yl, batch_size=BS, seed=2)
    tlu = DataLoader(xu, batch_size=BS, seed=1, device_resident=False,
                     stream_chunks=chunks, device="cpu")
    tls = DataLoader(xl, yl, batch_size=BS, seed=2, device="cpu")
    for _ in range(2):
        np.testing.assert_allclose(tt.train(tlu, tls, scale_factor=0.5),
                                   jt.train(jlu, jls, scale_factor=0.5),
                                   rtol=LOSS_RTOL)
    _check_params(tm, jm)


NARROW = [("bfloat16", None), ("float16", None), (("bfloat16", None), None),
          ("bfloat16", 0.5), (("float16", "bfloat16"), (2.0, None))]


@pytest.mark.parametrize("store,scale", NARROW,
                         ids=["bf16", "f16", "bf16_tuple", "bf16_scale",
                              "both"])
def test_store_dtype_values_are_the_jax_packages(store, scale):
    """The stored arrays bit for bit (bfloat16 as its bits, rounded to
    nearest even through float32, as ``ml_dtypes`` does, ties and float64
    sources included), the scales, and the float32 batches of a streamed
    and a resident loader; a scalar narrows only the signal array, labels
    stay untouched."""
    rng = np.random.default_rng(8)
    x = rng.uniform(-3, 3, (24, 5)).astype(np.float32)
    x[0, :3] = [1 + 2 ** -8, 1 + 3 * 2 ** -8, 1 + 2 ** -8 + 2 ** -20]  # ties
    y = rng.uniform(0, 1, (24, 2))  # float64 targets
    jl = JDataLoader(x, y, batch_size=8, shuffle=False, store_dtype=store,
                     scale=scale, device_resident=False)
    for resident in (False, True):
        tl = DataLoader(x, y, batch_size=8, shuffle=False, store_dtype=store,
                        scale=scale, device_resident=resident, device="cpu")
        assert tl.scale == jl.scale
        for ours, ref in zip(tl._host, jl._host):
            if ref.dtype == ml_dtypes.bfloat16:
                ref = ref.view(np.int16)
            assert ours.dtype == ref.dtype
            np.testing.assert_array_equal(ours, ref)
        for got, want in zip(iter(tl), iter(jl)):
            for g, w in zip(got, want):
                assert g.dtype == torch.float32
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if not isinstance(store, tuple):
        assert tl._host[1] is not None and tl._host[1].dtype == np.float64


def test_store_dtype_validation_as_jax():
    x = np.random.default_rng(5).uniform(0, 1, (10, 4)).astype(np.float32)
    for kw, msg in ((dict(store_dtype="int8"), "floating"),
                    (dict(store_dtype=("bfloat16", None)), "entries")):
        for cls in (JDataLoader, DataLoader):
            extra = {} if cls is JDataLoader else {"device": "cpu"}
            with pytest.raises(ValueError, match=msg):
                cls(x, **kw, **extra)
    with pytest.raises(ValueError, match="integer"):
        DataLoader(np.zeros((4, 3), np.uint8), store_dtype="bfloat16",
                   device="cpu")
    dl = DataLoader(x, store_dtype="float16", device="cpu")
    assert dl.device_arrays[0].dtype == torch.float16
    assert DataLoader(x, store_dtype="bfloat16",
                      device="cpu").device_arrays[0].dtype == torch.bfloat16


def test_native_matches_the_jax_packages_native():
    """``gather_rows`` (float32, uint8, a memmap, into a buffer) and
    ``u8_to_f32`` bit for bit against ``pyroved_tpu.native``; two epochs
    of ``BatchPipeline`` batches against the JAX package's C++ pipeline
    (whose shuffle is this one when its library loads)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(53, 6)).astype(np.float32)
    X8 = rng.integers(0, 256, (53, 6)).astype(np.uint8)
    idx = rng.integers(0, 53, 19).astype(np.int32)
    for src in (X, X8):
        np.testing.assert_array_equal(native.gather_rows(src, idx),
                                      jnative.gather_rows(src, idx))
        buf = np.empty((19, 6), src.dtype)
        assert native.gather_rows(src, idx, out=buf) is buf
        np.testing.assert_array_equal(buf, jnative.gather_rows(src, idx))
    for scale in (1 / 255.0, 0.5, 3.0):
        a, b = native.u8_to_f32(X8, scale), jnative.u8_to_f32(X8, scale)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    if jnative.get_lib() is None:
        pytest.skip("the JAX package's C++ library does not build here")
    with native.BatchPipeline(X, 8, seed=4) as ours, \
            jnative.BatchPipeline(X, 8, seed=4) as ref:
        for _ in range(2 * ours.num_batches):
            np.testing.assert_array_equal(ours.next(), ref.next())


def test_batch_pipeline_interface(tmp_path):
    """The streaming loader's batch sequence; a zero-copy view valid until
    the next call; ``close`` twice; ``next`` after ``close`` raises; a
    memmap source."""
    X = np.random.default_rng(1).uniform(0, 1, (40, 5)).astype(np.float32)
    path = str(tmp_path / "x.npy")
    np.save(path, X)
    src = np.load(path, mmap_mode="r")
    loader = DataLoader(X, batch_size=8, seed=3, device_resident=False,
                        device="cpu")
    with native.BatchPipeline(src, 8, seed=3, depth=2) as a, \
            native.BatchPipeline(X, 8, seed=3) as b:
        for _ in range(2):
            for (ref,) in loader:
                view = b.next(copy=False)
                snapshot = view.copy()
                np.testing.assert_array_equal(a.next(), ref.numpy())
                np.testing.assert_array_equal(view, ref.numpy())
                np.testing.assert_array_equal(view, snapshot)
    pipe = native.BatchPipeline(X, 8)
    pipe.next()
    pipe.close()
    pipe.close()
    with pytest.raises(RuntimeError, match="closed"):
        pipe.next()


def test_streaming_errors_and_recovery():
    """A batch larger than the first raises ``ValueError`` (unlabeled or
    labeled), and the trainer trains on afterwards; an iterable of the aux
    trainer without a length needs ``sup_period``; an error inside a
    prefetched loader reaches the consumer; a streaming loader built
    afresh at epoch e visits the resident loader's permutation."""
    X = _x()
    m = tmodels.iVAE(DATA, invariances=["r"], device="cpu", **SMALL)
    t = SVItrainer(m)
    with pytest.raises(ValueError, match="larger than the first batch"):
        t.train(iter([(X[:8],), (X[:16],)]))
    assert np.isfinite(t.train(_loader(X, 0, device_resident=False)))
    sm = tmodels.ssiVAE(DATA, 2, 3, ["r"], device="cpu", **SMALL)
    at = auxSVItrainer(sm)
    yl = np.eye(3, dtype=np.float32)[np.arange(16) % 3]
    with pytest.raises(ValueError, match="larger than the first labeled"):
        at.train(iter([(X[:8],), (X[8:16],), (X[16:24],)]),
                 [(X[:4], yl[:4]), (X[:8], yl[:8])], sup_period=1)
    with pytest.raises(TypeError, match="sup_period"):
        at.train(iter([(X[:8],)]), iter([(X[:4], yl[:4])]))
    assert np.isfinite(at.train([(X[:8],), (X[8:16],)],
                                [(X[:4], yl[:4])]))

    def broken():
        yield (X[:8],)
        raise RuntimeError("bad shard")

    with pytest.raises(RuntimeError, match="bad shard"):
        t.train(prefetch(broken()))
    resident = DataLoader(X, batch_size=BS, seed=SEED, device="cpu")
    streaming = DataLoader(X, batch_size=BS, seed=SEED, device="cpu",
                           device_resident=False)
    streaming.set_epoch(3)
    for a, b in zip(streaming.epoch_indices(), resident.epoch_indices(3)):
        np.testing.assert_array_equal(a, b)
