"""The port's ``grad_accum`` (``optax.MultiSteps`` semantics: the mean of k
micro-batch gradients, one Adam step every k-th micro-step, the window
carried across epochs and through checkpoints) in both trainers, and
``remat`` in ``SVItrainer`` (``torch.utils.checkpoint`` around the step's
loss), against manual computations in the port and the JAX package's
trainers, on the CPU."""
import numpy as np
import pytest
import torch

import jax

import pyroved_tpu.models as jmodels
from pyroved_tpu.trainers.auxsvi import auxSVItrainer as JauxSVItrainer
from pyroved_tpu.trainers.svi import SVItrainer as JSVItrainer
from pyroved_tpu.utils.data import init_dataloader as jinit_dataloader
import pyroved_tpu_torch.models as tmodels
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.trainers import SVItrainer, auxSVItrainer
from pyroved_tpu_torch.utils.data import init_dataloader
from pyroved_tpu_torch.utils.nn import as_numpy
from pyroved_tpu_torch.weights import from_jax_params

from test_torch_port_segmented import JaxNoiseAux, JaxNoiseSVI

# Parameters after a few Adam updates and per-epoch losses against the JAX
# trainers, f32 on both sides (PERF.md section 2)
PARAM_ATOL, PARAM_RTOL = 1e-4, 1e-3
LOSS_RTOL = 1e-5
DATA = (12, 12)
SMALL = dict(hidden_dim_e=(32,), hidden_dim_d=(32,))
N, BS = 40, 16  # three batches an epoch: a window of 2 spans epochs


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
    monkeypatch.setattr(tsd, "BF16_MATMUL", False)


def _x(n=N, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n,) + DATA).astype(
        np.float32)


def _ivae(seed=2, **kw):
    return tmodels.iVAE(DATA, invariances=["r"], device="cpu", seed=seed,
                        **SMALL, **kw)


def _params(model):
    return [p.detach().clone() for p in model.nets.parameters()]


def _bitwise(a, b):
    assert len(a) == len(b)
    for p, q in zip(a, b):
        assert torch.equal(p, q)


def _check_params(tm, jm):
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    for name, p in tm.nets.named_parameters():
        np.testing.assert_allclose(as_numpy(p), ref[name].numpy(),
                                   atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=name)


def _adam_steps(optimizer):
    return sorted({int(s["step"]) for s in optimizer.state.values()})


def test_grad_accum_equals_a_manual_mean_grad_step():
    """Three micro-steps of ``grad_accum=3``: no parameter moves and Adam
    holds no state until the third; then one Adam step on the running mean
    ``acc + (g - acc) / (n + 1)`` of the three grads, bit for bit (and
    within float32 rounding of their plain mean)."""
    X = _x()
    m, ref = _ivae(), _ivae()
    t = SVItrainer(m, grad_accum=3)
    gen = torch.Generator().manual_seed(0)
    batches = [(torch.from_numpy(X[i:i + BS]),) for i in (0, 16, 24)]
    w = torch.ones(BS)
    eps = [torch.randn(BS, m.z_dim, generator=gen) for _ in range(3)]
    before = _params(m)
    for i in range(2):
        t.train_step(batches[i], w, 1.0, eps[i])
        _bitwise(_params(m), before)
        assert not t.optimizer.state and t.grad_accumulator.mini_step == i + 1
    t.train_step(batches[2], w, 1.0, eps[2])
    assert _adam_steps(t.optimizer) == [1]
    assert t.grad_accumulator.mini_step == 0
    grads = []
    for b, e in zip(batches, eps):
        ref.nets.zero_grad(set_to_none=True)
        ref.weighted_loss_fn(b[0], None, w, 1.0, eps=e).backward()
        grads.append([p.grad.clone() for p in ref.nets.parameters()])
    opt = torch.optim.Adam(ref.nets.parameters(), lr=1e-3)
    for p, *g in zip(ref.nets.parameters(), *grads):
        acc = torch.zeros_like(p)
        for n, gi in enumerate(g):
            acc = acc + (gi - acc) / float(n + 1)
        np.testing.assert_allclose(acc.numpy(), (sum(g) / 3).numpy(),
                                   rtol=1e-5, atol=1e-6)
        p.grad = acc
    opt.step()
    _bitwise(_params(m), _params(ref))


def _svi_pair(seed=3, **kw):
    jm = jmodels.iVAE(DATA, invariances=["r"], seed=seed, **SMALL)
    tm = _ivae()
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, tm


def test_grad_accum_follows_jax_multisteps_across_epochs():
    """Three epochs of three micro-steps at ``grad_accum=2``: the window
    carries across epochs (epoch 1 ends mid-window), the JAX trainer's
    ``MultiSteps`` counters after each epoch, Adam's step count, and the
    per-epoch losses and final parameters against the JAX trainer's."""
    X = _x()
    jm, tm = _svi_pair()
    jt, tt = JSVItrainer(jm, seed=9, grad_accum=2), JaxNoiseSVI(
        tm, 9, grad_accum=2)
    jl = jinit_dataloader(X, batch_size=BS, seed=1)
    tl = init_dataloader(X, batch_size=BS, seed=1, device="cpu")
    for epoch in range(3):
        np.testing.assert_allclose(tt.train(tl), jt.train(jl),
                                   rtol=LOSS_RTOL)
        micro = 3 * (epoch + 1)
        assert tt.grad_accumulator.mini_step == int(jt.opt_state.mini_step)
        assert tt.grad_accumulator.mini_step == micro % 2
        assert _adam_steps(tt.optimizer) == [micro // 2] == [
            int(jt.opt_state.gradient_step)]
    _check_params(tm, jm)


@pytest.mark.parametrize("trainer", ["svi", "aux"])
def test_checkpoint_mid_window_resumes_bitwise(trainer, tmp_path):
    """An epoch that ends mid-window, a checkpoint, a fresh model and
    trainer that resume (other seeds), two more epochs: bitwise equal to
    three epochs in one go; a trainer of another ``grad_accum`` refuses
    the checkpoint."""
    X, Xl = _x(), _x(16, 4)
    yl = np.eye(3, dtype=np.float32)[np.arange(16) % 3]

    def make(seed):  # 3 basic micro-steps an epoch (svi), 4 (aux)
        if trainer == "svi":
            m = _ivae(seed=seed)
            return m, SVItrainer(m, seed=seed + 1, grad_accum=2)
        m = tmodels.ssiVAE(DATA, 2, 3, ["r"], device="cpu", seed=seed,
                           **SMALL)
        return m, auxSVItrainer(m, seed=seed + 1, grad_accum=3)

    def run(t, epoch, n):
        lu = init_dataloader(X, batch_size=BS, seed=1, device="cpu")
        lu.set_epoch(epoch)
        if trainer == "svi":
            return t.run(lu, n)
        ls = init_dataloader(Xl, yl, batch_size=8, seed=2, device="cpu")
        ls.set_epoch(epoch)
        return t.run(lu, ls, n)

    whole_m, whole = make(0)
    run(whole, 0, 3)
    first_m, first = make(0)
    run(first, 0, 1)
    assert first.grad_accumulator.mini_step == 1
    path = str(tmp_path / "ckpt.npz")
    from pyroved_tpu_torch.utils.checkpoint import save_checkpoint
    save_checkpoint(path, first_m, first)
    m, t = make(5)
    assert t.resume(path) == 1 and t.grad_accumulator.mini_step == 1
    run(t, 1, 2)
    hist = getattr(t, "loss_history", None) or t.history
    ref = getattr(whole, "loss_history", None) or whole.history
    assert hist == ref
    _bitwise(_params(m), _params(whole_m))
    other = (SVItrainer(_ivae()) if trainer == "svi" else auxSVItrainer(
        tmodels.ssiVAE(DATA, 2, 3, ["r"], device="cpu", **SMALL),
        grad_accum=2))
    with pytest.raises(ValueError, match="grad_accum"):
        other.resume(path)


def test_aux_grad_accum_interleave_matches_jax():
    """auxSVItrainer at ``grad_accum=2``: unlabeled steps and the basic
    half of labeled steps count toward the window, the auxiliary Adam over
    ``encoder_y`` steps at every labeled step; the counters and the
    trained parameters against the JAX trainer's over three epochs."""
    xu, xl = _x(48, 1), _x(32, 2)
    yl = np.eye(3, dtype=np.float32)[np.arange(32) % 3]
    jm = jmodels.ssiVAE(DATA, 2, 3, ["r"], seed=4, **SMALL)
    tm = tmodels.ssiVAE(DATA, 2, 3, ["r"], device="cpu", **SMALL)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    jt, tt = JauxSVItrainer(jm, seed=2, grad_accum=2), JaxNoiseAux(
        tm, 2, grad_accum=2)
    jl = (jinit_dataloader(xu, batch_size=BS, seed=1),
          jinit_dataloader(xl, yl, batch_size=BS, seed=2))
    tl = (init_dataloader(xu, batch_size=BS, seed=1, device="cpu"),
          init_dataloader(xl, yl, batch_size=BS, seed=2, device="cpu"))
    for epoch in range(3):
        np.testing.assert_allclose(tt.train(*tl), jt.train(*jl),
                                   rtol=LOSS_RTOL)
        micro = 4 * (epoch + 1)  # 3 unlabeled and 1 labeled basic steps
        assert tt.grad_accumulator.mini_step == int(jt.opt_state.mini_step)
        assert _adam_steps(tt.optimizer) == [micro // 2] == [
            int(jt.opt_state.gradient_step)]
        assert _adam_steps(tt.aux_optimizer) == [epoch + 1]
    _check_params(tm, jm)


@pytest.mark.parametrize("one_pass", [False, True], ids=["K1K2", "K3"])
@pytest.mark.parametrize("accum", [1, 2])
def test_remat_is_bitwise_no_remat(one_pass, accum, monkeypatch):
    """``remat=True`` recomputes the step's forward in the backward on the
    same noise: two epochs bitwise equal to ``remat=False``, through the
    decoder's K1/K2 wrappers (twice K1 and once K2 a step) or the one-pass
    K3 (twice a step), with and without ``grad_accum``."""
    calls = {"K1": 0, "K2": 0, "K3": 0}
    wrap = {"K1": "fused_spatial_decoder_forward",
            "K2": "fused_spatial_decoder_backward",
            "K3": "fused_bernoulli_recon_loss_kernel"}
    for k, name in wrap.items():
        fn = getattr(tsd, name)

        def counted(*a, _fn=fn, _k=k, **kw):
            calls[_k] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tsd, name, counted)
    X = _x()
    out = {}
    for remat in (False, True):
        for k in calls:
            calls[k] = 0
        m = _ivae(one_pass_train=one_pass)
        t = SVItrainer(m, seed=4, remat=remat, grad_accum=accum)
        losses = t.run(init_dataloader(X, batch_size=BS, seed=1,
                                       device="cpu"), 2)
        out[remat] = (losses, _params(m), dict(calls))
    assert out[True][0] == out[False][0]
    _bitwise(out[True][1], out[False][1])
    steps = 6
    expect = ({"K1": 0, "K2": 0, "K3": steps} if one_pass
              else {"K1": steps, "K2": steps, "K3": 0})
    assert out[False][2] == expect
    assert out[True][2] == {k: v * (2 if k != "K2" else 1)
                            for k, v in expect.items()}


def test_remat_matches_jax_remat():
    """Two epochs with ``remat=True`` against the JAX trainer's, whose
    remat runs its generic loss path: losses and parameters within the f32
    tolerances (the two paths round differently; not bitwise)."""
    X = _x()
    jm, tm = _svi_pair(seed=6)
    jt, tt = JSVItrainer(jm, seed=3, remat=True), JaxNoiseSVI(tm, 3,
                                                              remat=True)
    ref = jt.run(jinit_dataloader(X, batch_size=BS, seed=2), 2)
    got = tt.run(init_dataloader(X, batch_size=BS, seed=2, device="cpu"), 2)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    _check_params(tm, jm)
