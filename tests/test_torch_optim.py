"""The port's AdamW and schedules (`repro_torch.optim`) against the JAX
package's on the CPU: five steps on identical gradients agree to 1e-6 on
every arch's parameter tree (smoke size, the reference's decay rule leaf
for leaf), the schedule bit for bit in float32, and the twins of
`tests/test_substrate.py`'s optimizer tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import layers as JL
from repro.optim import adamw_init as j_init
from repro.optim import adamw_update as j_update
from repro.optim import clip_by_global_norm as j_clip
from repro.optim.schedule import linear_warmup_cosine as j_sched
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import steps as tsteps
from repro_torch.optim import (AdamWState, adamw_init, adamw_init_specs,
                               adamw_update, clip_by_global_norm,
                               cosine_schedule, linear_warmup_cosine)

TOL = dict(rtol=1e-6, atol=1e-6)


def _ref_tree(name, seed=0):
    cfg = jconfigs.get_smoke(name)
    m = jsteps.build_model(cfg)
    return m, m.init(jax.random.PRNGKey(seed),
                     JL.Runtime(compute_dtype=jnp.float32))


@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_five_steps_match_the_reference(name):
    """Identical gradients (numpy, in the reference's layout, converted),
    the reference's default hyper-parameters, an lr that changes each
    step; params and both moments after every step within 1e-6, grad
    norms within 1e-6 relative."""
    tcfg = tconfigs.get_smoke(name)
    tm = tsteps.build_model(tcfg)
    _, jp = _ref_tree(name)
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp))
    jstate, tstate = j_init(jp), adamw_init(tp)
    rng = np.random.default_rng(3)
    update = jax.jit(j_update)
    for step in range(5):
        g_np = jax.tree.map(
            lambda p: (rng.standard_normal(p.shape) * 0.01).astype(
                np.float32), jp)
        lr = 1e-3 * (step + 1)
        jp, jstate, jn = update(jax.tree.map(jnp.asarray, g_np), jstate,
                                jp, jnp.float32(lr))
        tp, tstate, tn = adamw_update(params_from_numpy(tcfg, g_np), tstate,
                                      tp, torch.tensor(lr),
                                      decay=tm.decay_mask())
        assert abs(float(tn) / float(jn) - 1) <= 1e-6
        for got, want in ((tp, jp), (tstate.mu, jstate.mu),
                          (tstate.nu, jstate.nu)):
            for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(
                    params_from_numpy(tcfg, jax.tree.map(np.asarray,
                                                         want)))):
                np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    assert int(tstate.step) == 5 and tstate.step.dtype == torch.int32


@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_decay_mask_is_the_references(name):
    """`decay_mask()` says, leaf for leaf in the port's layout, what the
    reference decays: `ndim >= 2` of its own (stacked) leaves, carried
    across as a tree of the reference's shapes filled with that bit."""
    tcfg = tconfigs.get_smoke(name)
    _, jp = _ref_tree(name)
    bits = params_from_numpy(tcfg, jax.tree.map(
        lambda p: np.full(p.shape, p.ndim >= 2, np.float32), jp))
    mask = tsteps.build_model(tcfg).decay_mask()
    paths = pytree.tree_flatten_with_path(bits)[0]
    for path, b in paths:
        want = bool(b.flatten()[0])
        assert torch.all(b == float(want)), path
        node = mask
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        assert node is want, (pytree.keystr(path), node, want)
    # the port's 1-D leaves the reference does not decay: qwen2-0.5b's
    # final norm alone (its layers are one stacked group); every 1-D leaf
    # of recurrentgemma-9b's smoke tree (groups of one repeat)
    kept = [pytree.keystr(p) for p, b in paths
            if b.dim() < 2 and not bool(b.flatten()[0])]
    if name == "qwen2-0.5b":
        assert kept == ["['final_norm']"]
    if name == "recurrentgemma-9b":
        assert len(kept) == 21


def test_clip_by_global_norm_matches_the_reference():
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32) * 10]}
    for max_norm in (1.0, 100.0):
        jc, jn = j_clip(jax.tree.map(jnp.asarray, tree), max_norm)
        tc, tn = clip_by_global_norm(pytree.tree_map(torch.from_numpy, tree),
                                     max_norm)
        assert abs(float(tn) / float(jn) - 1) <= 1e-6
        for g, w in zip(pytree.tree_leaves(tc), jax.tree.leaves(jc)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # the 1e-9 floor: zero gradients stay zero, no NaN
    zc, zn = clip_by_global_norm({"z": torch.zeros(3)}, 1.0)
    assert float(zn) == 0.0 and torch.equal(zc["z"], torch.zeros(3))


def test_clip_by_global_norm():
    """Twin of `tests/test_substrate.py::test_clip_by_global_norm`."""
    grads = {"a": torch.full((4,), 10.0)}
    clipped, norm = clip_by_global_norm(grads, 1.0)
    assert float(norm) == pytest.approx(20.0)
    total = torch.sqrt(sum(torch.sum(x ** 2)
                           for x in pytree.tree_leaves(clipped)))
    assert float(total) == pytest.approx(1.0, rel=1e-5)


@pytest.mark.parametrize("base_lr,warmup,total", [
    (3e-4, 10, 100), (1.0, 10, 100), (3e-3, 4, 40), (1e-3, 1, 7),
    (3e-4, 0, 12)])
def test_schedule_is_bit_equal_in_float32(base_lr, warmup, total):
    """`linear_warmup_cosine` at every step from 0 to total + 5, as a
    float32 0-d tensor, bit for bit the reference's."""
    for step in range(total + 6):
        want = np.asarray(j_sched(jnp.asarray(step, jnp.int32),
                                  base_lr=base_lr, warmup_steps=warmup,
                                  total_steps=total))
        got = linear_warmup_cosine(torch.tensor(step, dtype=torch.int32),
                                   base_lr=base_lr, warmup_steps=warmup,
                                   total_steps=total)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert got.numpy().tobytes() == want.tobytes(), (step, got, want)


def test_warmup_cosine_shape():
    """Twin of `tests/test_substrate.py::test_warmup_cosine_shape`."""
    lrs = [float(linear_warmup_cosine(torch.tensor(s), base_lr=1.0,
                                      warmup_steps=10, total_steps=100))
           for s in range(100)]
    assert lrs[0] == 0.0
    assert max(lrs) == pytest.approx(1.0, rel=1e-3)
    assert lrs[-1] < 0.2
    assert float(cosine_schedule(torch.tensor(0), base_lr=1.0,
                                 total_steps=10)) == pytest.approx(1.0)


def test_adamw_optimizes_quadratic():
    """Twin of `tests/test_substrate.py::test_adamw_optimizes_quadratic`."""
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    lr = torch.tensor(0.1)
    for _ in range(200):
        grads = {"w": 2.0 * params["w"]}
        params, opt, _ = adamw_update(grads, opt, params, lr,
                                      weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.2


def test_update_is_in_place_and_init_is_the_references():
    """The update writes the parameters and moments it was given (the
    reference's donation); the moments start at fp32 zeros, the step at
    an int32 0; `adamw_init_specs` gives their shapes and dtypes."""
    p = {"w": torch.ones(3, 2), "b": torch.ones(2)}
    st = adamw_init(p)
    assert isinstance(st, AdamWState) and st.step.dtype == torch.int32
    assert all(m.dtype == torch.float32 and not m.any()
               for m in pytree.tree_leaves((st.mu, st.nu)))
    w, mu = p["w"], st.mu["w"]
    p2, st2, _ = adamw_update({"w": torch.ones(3, 2), "b": torch.ones(2)},
                              st, p, torch.tensor(0.1))
    assert p2["w"] is w and st2.mu["w"] is mu and bool((w < 1).all())
    specs = adamw_init_specs({"w": torch.empty(3, 2)})
    assert specs.step == ((), torch.int32)
    assert specs.mu == {"w": ((3, 2), torch.float32)}


def test_cosf_is_xlas_cos():
    """XLA's f32 `cos` on the CPU is glibc's `cosf`; `_cosf` is too, bit
    for bit on 200,001 points of [0, pi] (the schedule's range) and at
    pi/2, where the cosine rounds through zero."""
    from repro_torch.optim.schedule import _cosf
    x = np.append(np.linspace(0, np.pi, 200001, dtype=np.float32),
                  np.float32(np.pi) * np.float32(0.5))
    want = np.asarray(jax.jit(jnp.cos)(x))
    got = _cosf(torch.from_numpy(x)).numpy()
    assert got.tobytes() == want.tobytes()
