"""Data-parallel QAT training in the port against the reference's, on the CPU.

The collective (`repro_torch.distributed.collectives`) against
`repro.distributed.collectives` under ``jax.vmap(..., axis_name="data")``
on the same numpy gradients and residuals; a whole DP step
(`training.kws.dp_value_and_grad` / `dp_train_step`) against the
reference example's step (`examples/train_kws.py`: ``value_and_grad`` of
the QAT loss, the sync, ``pmean`` of the loss) under ``jax.jit`` of that
``vmap``, compressed and plain; the plain DP step against the
single-device step on the whole batch; shards that share a device.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core import gru as jg
from repro.distributed import collectives as jcoll
from repro.training import optimizer as jo
from repro_torch import convert
from repro_torch.distributed import collectives as tcoll
from repro_torch.training import kws
from repro_torch.training import optimizer as to
from repro_torch.training.checkpoint import _flatten_with_names

# per-shard gradients of the port against jax.grad, as tests/test_torch_train.py
# holds them: max |difference| / max |reference gradient| a leaf
GRAD_TOL = 2e-6
B, T = 8, 8


def _loss_ref(p, fv, y):
    logits = jg.gru_classifier_forward(p, fv, jg.GRUConfig())[:, -1, :]
    logz = jax.nn.logsumexp(logits, -1)
    gold = jnp.take_along_axis(logits, y[:, None], -1)[:, 0]
    return jnp.mean(logz - gold)


def _ref_dp(p, fv, y, r):
    """The reference example's DP body, both syncs at once (one
    compilation): (loss, each shard's own gradients, the plain mean, the
    compressed mean, the new residuals)."""
    loss, g = jax.value_and_grad(_loss_ref)(p, fv, y)
    plain = jax.tree.map(lambda t: jax.lax.pmean(t, "data"), g)
    synced, r = jcoll.compressed_psum_with_error_feedback(g, r, "data")
    return jax.lax.pmean(loss, "data"), g, plain, synced, r


# the oracle of this slice: that body vmapped over the shard axis and jitted
_REF_DP = jax.jit(jax.vmap(_ref_dp, in_axes=(None, 0, 0, 0), axis_name="data"))


def _shared(seed, b=B):
    params = jax.tree.map(np.array, jg.init_gru_classifier(jax.random.PRNGKey(seed), jg.GRUConfig()))
    rng = np.random.default_rng(seed)
    fv = (np.round(rng.standard_normal((b, T, 16)) * 256) / 256).astype(np.float32)
    y = rng.integers(0, 12, b).astype(np.int32)
    return params, fv, y


def _stacked_tree(params, n, scale, seed):
    """One random tree a shard shaped like ``params``, stacked on a
    leading shard axis (the reference's layout)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (rng.standard_normal((n,) + p.shape) * scale).astype(np.float32), params)


def _shard(tree, i):
    return jax.tree.map(lambda a: np.asarray(a)[i], tree)


def _port_tree(tree):
    return convert.params_from_numpy(tree, "cpu")


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _names_and_leaves(port_tree, ref_tree):
    port = _flatten_with_names(port_tree)
    from repro.training import checkpoint as jckpt

    ref = jckpt._flatten_with_names(ref_tree)
    assert [n for n, _ in port] == [n for n, _ in ref]
    return [(n, x.numpy(), np.asarray(r)) for (n, x), (_, r) in zip(port, ref)]


@pytest.mark.parametrize("n", [2, 3, 4])
def test_collective_equals_the_references(n):
    """Synced gradients and every shard's residual array-equal to the
    reference's under ``jax.vmap``, at 2, 3 and 4 shards (3: the division
    by n is a true division there, in both); the plain mean likewise."""
    # a tree of the classifier's layout, its leaves of one shape (each
    # shape costs the eager reference a compilation a primitive)
    leaf = np.zeros((48, 144), np.float32)
    params = {"gru": [{"w_i": leaf, "w_h": leaf}], "fc": {"w": leaf}}
    g = _stacked_tree(params, n, 0.01, seed=n)
    r = _stacked_tree(params, n, 1e-4, seed=10 + n)
    ref_g, ref_r = jax.vmap(lambda g, r: jcoll.compressed_psum_with_error_feedback(g, r, "data"),
                            axis_name="data")(g, r)
    got_g, got_r = tcoll.compressed_psum_with_error_feedback(
        [_torch_tree(_shard(g, i)) for i in range(n)], [_torch_tree(_shard(r, i)) for i in range(n)])
    ref_mean = jax.vmap(lambda g: jax.tree.map(lambda t: jax.lax.pmean(t, "data"), g),
                        axis_name="data")(g)
    got_mean = tcoll.pmean([_torch_tree(_shard(g, i)) for i in range(n)])
    for i in range(n):
        for got, ref in ((got_g[i], ref_g), (got_r[i], ref_r), (got_mean[i], ref_mean)):
            for name, a, b in _names_and_leaves(got, _shard(ref, i)):
                np.testing.assert_array_equal(a, b, err_msg=f"shard {i} {name}")


def test_residual_identity():
    """What a shard sends plus what it keeps is what it had, exactly:
    ``q * scale + residual == g + r_prev`` with integer codes in
    [-127, 127] and one scale for all shards; the synced mean is the codes'
    sum times scale over n."""
    n = 3
    rng = np.random.default_rng(5)
    g = [torch.from_numpy(rng.standard_normal((48, 12)).astype(np.float32) * 0.3) for _ in range(n)]
    r = [torch.from_numpy(rng.standard_normal((48, 12)).astype(np.float32) * 1e-3) for _ in range(n)]
    mean, new_r = tcoll.compressed_psum_with_error_feedback(g, r)
    g32 = [a + b for a, b in zip(g, r)]
    scale = torch.stack([x.abs().max() for x in g32]).max() / torch.tensor(127.0) + 1e-12
    codes = []
    for x, nr in zip(g32, new_r):
        sent = x - nr
        q = sent / scale
        assert torch.equal(q, torch.round(q)) and float(q.abs().max()) <= 127
        assert torch.equal(sent.double() + nr.double(), x.double())
        assert float(nr.abs().max()) <= float(scale) / 2
        codes.append(q)
    want = torch.stack(codes).sum(0) * scale / torch.tensor(float(n))
    for m in mean:
        assert torch.equal(m, want)


def _codes(g32_shards, scale):
    return [np.clip(np.round(x / scale), -127, 127) for x in g32_shards]


@pytest.mark.parametrize("compress", [True, False], ids=["compressed", "plain"])
def test_dp_step_follows_the_references_jitted_step(compress):
    """Four shards of two rows: the loss within 1e-6; plain: the synced
    gradients within GRAD_TOL of max |g| and the params after AdamW within
    a tenth of the learning rate (tests/test_torch_train.py); compressed:
    every shard's int8 codes equal to the reference's except where the
    reference's value lies within the gradients' tolerance of a rounding
    tie, and where all codes agree the synced gradients and residuals
    within GRAD_TOL of max |g|."""
    n = 4
    params, fv, y = _shared(2)
    r = _stacked_tree(params, n, 1e-4, seed=3) if compress else jax.tree.map(
        lambda p: np.zeros((n,) + p.shape, np.float32), params)
    p_ref = jax.tree.map(jnp.asarray, params)
    sharded = (jnp.asarray(fv.reshape(n, B // n, T, 16)), jnp.asarray(y.reshape(n, B // n)))
    ref_loss, ref_shard_g, ref_plain, ref_synced, ref_r = _REF_DP(
        p_ref, *sharded, jax.tree.map(jnp.asarray, r))
    ref_g = ref_synced if compress else ref_plain

    replicas = [_port_tree(params) for _ in range(n)]
    residual = [_port_tree(_shard(r, i)) for i in range(n)] if compress else None
    loss, grads, new_r = kws.dp_value_and_grad(replicas, torch.from_numpy(fv), torch.from_numpy(y),
                                               residual=residual)
    assert abs(float(loss) - float(ref_loss[0])) <= 1e-6
    for i in range(1, n):
        for (_, a), (_, b) in zip(_flatten_with_names(grads[0]), _flatten_with_names(grads[i])):
            assert torch.equal(a, b)
    if not compress:
        assert new_r is None
        for name, a, b in _names_and_leaves(grads[0], _shard(ref_g, 0)):
            assert np.abs(a - b).max() <= GRAD_TOL * np.abs(b).max(), name
        ocfg = jo.AdamWConfig(lr=1e-3, weight_decay=0.01)
        ref_p, _, _ = jax.jit(jo.adamw_update, static_argnums=3)(
            p_ref, _shard(ref_g, 0), jax.jit(jo.init_opt_state, static_argnums=1)(p_ref, ocfg), ocfg)
        opts = [to.init_opt_state(p, kws.OPT) for p in replicas]
        new_p, _, _, _ = kws.dp_train_step(replicas, opts, torch.from_numpy(fv),
                                           torch.from_numpy(y), 1e-3)
        for name, a, b in _names_and_leaves(new_p[0], ref_p):
            np.testing.assert_allclose(a, b, rtol=0, atol=0.1e-3, err_msg=name)
        return

    # each shard's own gradients (before the sync), both packages
    port_shard_g = [kws.value_and_grad(_port_tree(params), torch.from_numpy(fv[i * 2:i * 2 + 2]),
                                       torch.from_numpy(y[i * 2:i * 2 + 2]))[1] for i in range(n)]
    flipped = total = 0
    for leaf, (name, _, _) in enumerate(_names_and_leaves(grads[0], _shard(ref_g, 0))):
        port_g32 = [_flatten_with_names(port_shard_g[i])[leaf][1].numpy()
                    + _flatten_with_names(residual[i])[leaf][1].numpy() for i in range(n)]
        ref_g32 = [np.asarray(jax.tree.leaves(_shard(ref_shard_g, i))[leaf]) + np.asarray(
            jax.tree.leaves(_shard(r, i))[leaf]) for i in range(n)]
        tol = GRAD_TOL * max(np.abs(x).max() for x in ref_g32)
        ref_scale = np.float32(max(np.abs(x).max() for x in ref_g32)) / np.float32(127) + np.float32(1e-12)
        port_scale = np.float32(max(np.abs(x).max() for x in port_g32)) / np.float32(127) + np.float32(1e-12)
        q_ref, q_port = _codes(ref_g32, ref_scale), _codes(port_g32, port_scale)
        agree = np.ones(q_ref[0].shape, bool)
        for i in range(n):
            differ = q_ref[i] != q_port[i]
            # only a value within the tolerance of a rounding tie may flip
            frac = np.abs(np.abs(ref_g32[i] / ref_scale) % 1.0 - 0.5)
            assert (frac[differ] <= 2 * tol / ref_scale + 1e-4).all(), name
            assert (np.abs(q_ref[i] - q_port[i]) <= 1).all(), name
            agree &= ~differ
        flipped += int((~agree).sum())
        total += agree.size
        got_mean = _flatten_with_names(grads[0])[leaf][1].numpy()
        ref_mean = np.asarray(jax.tree.leaves(_shard(ref_g, 0))[leaf])
        assert np.abs(got_mean - ref_mean)[agree].max(initial=0) <= tol, name
        for i in range(n):
            got_r = _flatten_with_names(new_r[i])[leaf][1].numpy()
            ref_ri = np.asarray(jax.tree.leaves(_shard(ref_r, i))[leaf])
            assert np.abs(got_r - ref_ri)[agree].max(initial=0) <= 2 * tol, (name, i)
    assert flipped <= 0.01 * total


def test_plain_dp_step_equals_the_single_device_step():
    """The plain mean of four shards' gradients is the gradient of the
    whole batch's mean loss: within GRAD_TOL of max |g| of `train_step`'s,
    the loss within 1e-6, the params after AdamW within a tenth of the
    learning rate, every replica alike."""
    params, fv, y = _shared(4)
    n = 4
    replicas = [_port_tree(params) for _ in range(n)]
    loss, grads, _ = kws.dp_value_and_grad(replicas, torch.from_numpy(fv), torch.from_numpy(y))
    one_loss, one = kws.value_and_grad(_port_tree(params), torch.from_numpy(fv), torch.from_numpy(y))
    assert abs(float(loss) - float(one_loss)) <= 1e-6
    for (name, a), (_, b) in zip(_flatten_with_names(grads[0]), _flatten_with_names(one)):
        assert float((a - b).abs().max()) <= GRAD_TOL * float(b.abs().max()), name
    opts = [to.init_opt_state(p, kws.OPT) for p in replicas]
    new_p, new_opt, _, _ = kws.dp_train_step(replicas, opts, torch.from_numpy(fv),
                                             torch.from_numpy(y), 1e-3)
    one_p, _, _ = kws.train_step(_port_tree(params), to.init_opt_state(_port_tree(params), kws.OPT),
                                 torch.from_numpy(fv), torch.from_numpy(y), 1e-3)
    for (name, a), (_, b) in zip(_flatten_with_names(new_p[0]), _flatten_with_names(one_p)):
        assert float((a - b).abs().max()) <= 0.1e-3, name
    for i in range(1, n):
        for (_, a), (_, b) in zip(_flatten_with_names((new_p[i], new_opt[i])),
                                  _flatten_with_names((new_p[0], new_opt[0]))):
            assert torch.equal(a, b)


def test_shards_may_share_a_device(monkeypatch):
    """``devices=`` entries naming one device: `fit` trains four shards
    there (compressed), the residual comes back one tree a shard; an int
    above the visible card count, a count that disagrees with ``dp`` and
    options without ``dp`` raise."""
    rng = np.random.default_rng(3)
    fv = torch.from_numpy((np.round(rng.standard_normal((32, 4, 16)) * 256) / 256).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 12, 32).astype(np.int32))
    from repro_torch.core import gru as tg

    params = tg.init_gru_classifier(tg.GRUConfig(), torch.Generator().manual_seed(0), "cpu")
    opt = to.init_opt_state(params, kws.OPT)
    out = kws.fit(params, opt, fv, y, 3, batch=8, log=lambda _: None, dp=4,
                  compress_grads=True, devices=["cpu"] * 4)
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert len(out["residual"]) == 4 and out["params"]["fc"]["w"].device.type == "cpu"
    assert all(float(r["fc"]["w"].abs().max()) > 0 for r in out["residual"])
    assert int(out["opt"]["step"]) == 3
    assert kws.dp_devices(2, None, "cpu") == [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="visible"):
        kws.dp_devices(2, 2)
    with pytest.raises(ValueError, match="dp=3"):
        kws.dp_devices(3, ["cpu"] * 2)
    with pytest.raises(ValueError, match="need dp"):
        kws.fit(params, opt, fv, y, 1, batch=8, compress_grads=True)
    with pytest.raises(ValueError, match="does not split"):
        kws.dp_value_and_grad([params] * 3, fv[:8], y[:8])


def test_one_shard_step_is_the_single_device_step():
    """`fit` runs every step through `dp_train_step`; over one shard (no
    ``dp``) the sync divides by one and the step equals `train_step`'s
    bit for bit: loss, params and AdamW state."""
    params, fv, y = _shared(5)
    fv, y = torch.from_numpy(fv), torch.from_numpy(y)
    p = _port_tree(params)
    dp_p, dp_o, dp_loss, resid = kws.dp_train_step([p], [to.init_opt_state(p, kws.OPT)], fv, y, 1e-3)
    one_p, one_o, one_loss = kws.train_step(p, to.init_opt_state(p, kws.OPT), fv, y, 1e-3)
    assert resid is None and torch.equal(dp_loss, one_loss)
    for (name, a), (_, b) in zip(_flatten_with_names((dp_p[0], dp_o[0])),
                                 _flatten_with_names((one_p, one_o)), strict=True):
        assert torch.equal(a, b), name


def test_elements_apart_counts_against_the_scale_leaf():
    """`elements_apart` counts, leaf by leaf, the elements further apart
    than ``tol`` times the max |x| of the scale tree's leaf."""
    want = {"a": torch.zeros(4, 3), "b": [torch.zeros(5)]}
    scale = {"a": torch.full((4, 3), 2.0), "b": [torch.full((5,), 10.0)]}
    got = {"a": torch.zeros(4, 3), "b": [torch.zeros(5)]}
    got["a"][0, 0], got["a"][1, 1] = 0.3, 0.1  # tol 0.1 of 2: only the first is off
    got["b"][0][2] = -1.5  # tol 0.1 of 10
    got["b"][0][3] = 0.9
    assert tcoll.elements_apart(got, want, scale, 0.1) == (2, 17)
    assert tcoll.elements_apart(want, want, scale, 0.0) == (0, 17)
