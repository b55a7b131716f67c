"""QAT training in the port against the reference's, on the CPU.

The same numpy params and batches go through ``jax.value_and_grad`` of
the reference's loss (`examples/train_kws.py`, `benchmarks/common.py`) and
the port's autograd (`repro_torch.training.kws`), QAT and float, and a
whole step (gradients, then AdamW) from a shared state. Then what only
the port has to keep: a resumed run equal to an unbroken one, checkpoints
of ``(params, opt)`` crossing the two packages, the integer replay of a
trained model reproducing its QAT decisions, the card as the default
device, and the command line end to end.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core import gru as jg
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jo
from repro_torch import convert
from repro_torch.core import gru as tg
from repro_torch.distributed.fault_tolerance import CheckpointManager, CheckpointPolicy
from repro_torch.training import kws
from repro_torch.training import optimizer as to
from repro_torch.training.checkpoint import _flatten_with_names

# Gradients of the port against jax.grad of the reference loss, per leaf,
# max |difference| / max |reference gradient|. The forward is equal on the
# grid, so every straight-through mask agrees; what differs is the order
# of the backward's sums (a reverse scan against autograd's loop) and
# sigmoid / tanh within 2 ulps. Measured at B = 4, T = 8 over seeds 0-3:
# QAT 3.4e-7, float 3.1e-7.
GRAD_TOL = 2e-6
B, T = 4, 8


def _loss_ref(p, fv, y, cfg):
    logits = jg.gru_classifier_forward(p, fv, cfg)[:, -1, :]
    logz = jax.nn.logsumexp(logits, -1)
    gold = jnp.take_along_axis(logits, y[:, None], -1)[:, 0]
    return jnp.mean(logz - gold)


_ref_value_and_grad = jax.jit(jax.value_and_grad(_loss_ref), static_argnums=3)


def _shared(seed, quantized=True, b=B, t=T):
    """Reference-initialized params and a batch of on-grid FV_Norm frames,
    as numpy."""
    cfg = jg.GRUConfig(quantized=quantized)
    params = jax.tree.map(np.array, jg.init_gru_classifier(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    fv = (np.round(rng.standard_normal((b, t, 16)) * 256) / 256).astype(np.float32)
    y = rng.integers(0, 12, b).astype(np.int32)
    return params, fv, y


def _ref_grads(params, fv, y, quantized):
    loss, g = _ref_value_and_grad(jax.tree.map(jnp.asarray, params), jnp.asarray(fv),
                                  jnp.asarray(y), jg.GRUConfig(quantized=quantized))
    return float(loss), g


def _port_grads(params, fv, y, quantized):
    loss, g = kws.value_and_grad(convert.params_from_numpy(params, "cpu"), torch.from_numpy(fv),
                                 torch.from_numpy(y), tg.GRUConfig(quantized=quantized))
    return float(loss), g


def _leaf_pairs(port_tree, ref_tree):
    port = [(n, x) for n, x in _flatten_with_names(port_tree)]
    ref = jckpt._flatten_with_names(ref_tree)
    assert [n for n, _ in port] == [n for n, _ in ref]
    return [(n, x.numpy(), np.asarray(r)) for (n, x), (_, r) in zip(port, ref)]


def _assert_grads_close(port, ref):
    for name, p, r in _leaf_pairs(port, ref):
        scale = np.abs(r).max()
        assert scale > 0, name
        err = np.abs(p - r).max() / scale
        assert err <= GRAD_TOL, (name, err)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("quantized", [True, False], ids=["qat", "float"])
def test_gradients_equal_jax_grad(quantized, seed):
    params, fv, y = _shared(seed, quantized)
    ref_loss, ref = _ref_grads(params, fv, y, quantized)
    loss, port = _port_grads(params, fv, y, quantized)
    assert abs(loss - ref_loss) <= 1e-6
    _assert_grads_close(port, ref)


def test_gradient_at_a_clip_bound():
    """A weight whose int8 code lands on -128 or 127 gets half the
    gradient (jnp.clip splits the tie), one beyond the format none."""
    params, fv, y = _shared(1)
    params["fc"]["w"][0, :] = -1.0  # code -128, the lower bound
    params["fc"]["w"][1, :] = 127 / 128  # code 127, the upper bound
    params["fc"]["w"][2, :] = 1.5  # code 192, clipped
    params["gru"][0]["w_i"][3, :] = -1.0
    _, ref = _ref_grads(params, fv, y, True)
    _, port = _port_grads(params, fv, y, True)
    _assert_grads_close(port, ref)
    for leaf, rows in (("fc", (0, 1)), ("gru", (3,))):
        r = np.asarray(ref["fc"]["w"] if leaf == "fc" else ref["gru"][0]["w_i"])
        # the tie rows carry gradients large enough that a factor of 2
        # (torch.clamp's 1 on a bound) would break GRAD_TOL many times over
        assert np.abs(r[list(rows)]).max() > 1e3 * GRAD_TOL * np.abs(r).max()
    assert not np.asarray(ref["fc"]["w"])[2].any()
    assert not port["fc"]["w"][2].any()


def _ref_state(params, state_dtype):
    cfg = jo.AdamWConfig(lr=1e-3, weight_decay=0.01, state_dtype=state_dtype)
    return cfg, jo.init_opt_state(jax.tree.map(jnp.asarray, params), cfg)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_train_step_follows_the_reference_step(state_dtype):
    """Three steps, each from the reference's params and optimizer state:
    the loss within 1e-6, the moments within GRAD_TOL of their largest
    entry (they carry the gradient), the int8 moment codes within one
    code, the params within a tenth of the learning rate (the first Adam
    step divides g by |g| + eps, so a gradient near eps moves its weight
    by up to the learning rate on a difference of GRAD_TOL)."""
    params, _, _ = _shared(0)
    ocfg, opt = _ref_state(params, state_dtype)
    tcfg = to.AdamWConfig(lr=1e-3, weight_decay=0.01, state_dtype=state_dtype)
    rng = np.random.default_rng(7)
    p = jax.tree.map(jnp.asarray, params)
    for _ in range(3):
        fv = (np.round(rng.standard_normal((B, T, 16)) * 256) / 256).astype(np.float32)
        y = rng.integers(0, 12, B).astype(np.int32)
        ref_loss, g = _ref_value_and_grad(p, jnp.asarray(fv), jnp.asarray(y), jg.GRUConfig())
        ref_p, ref_opt, _ = jo.adamw_update(p, g, opt, ocfg, 1e-3)
        tp = convert.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
        topt = convert.opt_state_from_numpy(jax.tree.map(np.asarray, opt), "cpu")
        new_p, new_opt, loss = kws.train_step(tp, topt, torch.from_numpy(fv),
                                              torch.from_numpy(y), 1e-3, tg.GRUConfig(), tcfg)
        assert abs(float(loss) - float(ref_loss)) <= 1e-6
        for name, a, r in _leaf_pairs(new_p, ref_p):
            np.testing.assert_allclose(a, r, rtol=0, atol=0.1e-3, err_msg=name)
        for name, a, r in _leaf_pairs(new_opt, ref_opt):
            if a.dtype == np.int8:
                assert np.abs(a.astype(int) - r.astype(int)).max() <= 1, name
            elif a.ndim:
                assert np.abs(a - r).max() <= GRAD_TOL * max(np.abs(r).max(), 1e-30), name
            else:
                assert a == r, name
        p, opt = ref_p, ref_opt


def _features(n=32, t=6, seed=3):
    rng = np.random.default_rng(seed)
    fv = (np.round(rng.standard_normal((n, t, 16)) * 256) / 256).astype(np.float32)
    return torch.from_numpy(fv), torch.from_numpy(rng.integers(0, 12, n).astype(np.int32))


def _fresh(state_dtype="float32"):
    params = tg.init_gru_classifier(tg.GRUConfig(), torch.Generator().manual_seed(0), "cpu")
    return params, to.init_opt_state(params, to.AdamWConfig(state_dtype=state_dtype))


def _manager(path, every):
    return CheckpointManager(CheckpointPolicy(str(path), every_steps=every, async_save=False))


def _tree_equal(a, b):
    for (na, x), (nb, y) in zip(_flatten_with_names(a), _flatten_with_names(b), strict=True):
        assert na == nb and x.dtype == y.dtype and torch.equal(x, y), na


def test_resumed_run_equals_the_unbroken_run(tmp_path):
    """k steps, a checkpoint, a restore into fresh params and the rest of
    the run: array-equal to the run without the break, the scheduler's
    state included."""
    fv, y = _features()
    params, opt = _fresh()
    whole = kws.fit(params, opt, fv, y, 2 * kws.WINDOW, batch=4,
                    ckpt=_manager(tmp_path / "whole", kws.WINDOW), log=lambda _: None)
    params, opt = _fresh()
    first = kws.fit(params, opt, fv, y, kws.WINDOW, batch=4,
                    ckpt=_manager(tmp_path / "broken", kws.WINDOW), log=lambda _: None)
    params, opt = _fresh()
    sched = to.ReduceLROnPlateau(*kws.SCHEDULE)
    params, opt, step = kws.resume(_manager(tmp_path / "broken", kws.WINDOW), params, opt, sched)
    assert step == kws.WINDOW
    _tree_equal((params, opt), (first["params"], first["opt"]))
    rest = kws.fit(params, opt, fv, y, 2 * kws.WINDOW, batch=4, start_step=step, sched=sched,
                   ckpt=_manager(tmp_path / "broken", kws.WINDOW), log=lambda _: None)
    _tree_equal((rest["params"], rest["opt"]), (whole["params"], whole["opt"]))
    assert first["losses"] + rest["losses"] == whole["losses"]
    assert vars(rest["sched"]) == vars(whole["sched"])
    assert whole["losses"][-1] < whole["losses"][0]


def _ref_trained(state_dtype):
    """Reference (params, opt) after two AdamW steps, so every moment
    leaf is non-zero."""
    params, fv, y = _shared(2)
    cfg, opt = _ref_state(params, state_dtype)
    p = jax.tree.map(jnp.asarray, params)
    for _ in range(2):
        _, g = _ref_value_and_grad(p, jnp.asarray(fv), jnp.asarray(y), jg.GRUConfig())
        p, opt, _ = jo.adamw_update(p, g, opt, cfg, 1e-3)
    return p, opt


def _bytes(x):
    return x.numpy().tobytes() if torch.is_tensor(x) else np.asarray(x).tobytes()


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_checkpoints_of_params_and_opt_cross_the_two_packages(tmp_path, state_dtype):
    ref = _ref_trained(state_dtype)
    # the reference writes, the port's trainer resumes from it
    jckpt.save_checkpoint(str(tmp_path / "ref"), 100, ref)
    params, opt = _fresh(state_dtype)
    sched = to.ReduceLROnPlateau(*kws.SCHEDULE)
    said = []
    got_p, got_opt, step = kws.resume(_manager(tmp_path / "ref", 100), params, opt, sched, said.append)
    assert step == 100 and said == ["no schedule saved at step 100; the schedule starts afresh"]
    pairs = list(zip(_flatten_with_names((got_p, got_opt)), jckpt._flatten_with_names(ref)))
    assert len(pairs) == len(jax.tree.leaves(ref)) == len(_flatten_with_names((params, opt)))
    for (name, x), (ref_name, r) in pairs:
        assert name == ref_name and str(x.dtype).removeprefix("torch.") == str(np.asarray(r).dtype)
        assert _bytes(x) == _bytes(r), name
    if state_dtype == "int8":
        assert got_opt["m"]["gru"][1]["w_i"]["q"].dtype == torch.int8
    # the port's trainer writes, the reference restores
    fv, y = _features()
    out = kws.fit(got_p, got_opt, fv, y, 102, batch=4, start_step=100, sched=sched,
                  ckpt=_manager(tmp_path / "port", 2), log=lambda _: None)
    back, step = jckpt.restore_checkpoint(str(tmp_path / "port"), ref)
    assert step == 102
    for (name, x), (_, r) in zip(_flatten_with_names((out["params"], out["opt"])),
                                 jckpt._flatten_with_names(back), strict=True):
        assert _bytes(x) == _bytes(r), name
    # the optimizer's own count: the reference's two updates, then the port's two
    assert int(np.asarray(back[1]["step"])) == 4


def test_integer_replay_gives_the_qat_confusion_matrix():
    fv, y = _features(n=48, t=8, seed=4)
    model = kws.train_classifier(fv.numpy(), y.numpy(), seed=0, epochs=3, batch=16, device="cpu")
    assert len(model["history"]) == 3 and all(np.isfinite(model["history"]))
    acc, conf = kws.evaluate(model, fv.numpy(), y.numpy())
    int_acc, int_conf = kws.evaluate(model, fv.numpy(), y.numpy(), classifier="integer")
    assert acc == int_acc and conf.sum() == 48
    np.testing.assert_array_equal(conf, int_conf)
    # every frame's logits, not only the decisions
    from repro_torch.core.classifier import get_classifier

    qat = get_classifier("qat").forward(model["params"], fv, tg.GRUConfig())
    integer = get_classifier("integer")
    codes = integer.forward(integer.prepare(model["params"], tg.GRUConfig()), fv, tg.GRUConfig())
    torch.testing.assert_close(codes, qat, rtol=0, atol=0)


def test_trainer_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fv, y = _features(n=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kws.train_classifier(fv.numpy(), y.numpy(), epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kws.train(steps=1, ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kws.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])


def test_main_trains_on_the_cpu(tmp_path, capsys):
    """The command line end to end at a tiny size: corpus, recorded
    features, steps, test accuracy and the integer replay."""
    rc = kws.main(["--steps", "4", "--batch", "4", "--n-per-class", "1", "--device", "cpu",
                   "--ckpt-dir", str(tmp_path), "--resume"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "no checkpoint found; starting fresh" in out
    assert "test accuracy" in out and "the same confusion matrix" in out
