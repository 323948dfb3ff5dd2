"""Training in the port (`models.lm` / `models.encdec` losses and remat,
`launch.steps.make_train_step`, `launch.train`) against the JAX package on
the CPU, at smoke size in fp32.

The same numpy inputs and the reference's parameters (converted leaf for
leaf, `repro_torch.convert`) go through both packages.  Losses agree
within 1e-5 relative and each gradient leaf within 1e-4 of that leaf's
largest magnitude; the train steps' losses, grad norms, lrs and
parameters within 1e-5.  One family of leaves has no such scale: a key
bias of a RoPE-free attention (whisper's `bk`) has a zero gradient in
exact arithmetic (the softmax over keys is invariant to the shift q.b_k
they share), so both packages return rounding noise; those leaves are
held below 1e-6 of the model's largest gradient in both."""

import dataclasses
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import layers as JL
from repro.optim import adamw_init as j_adamw_init
from repro_torch import configs as tconfigs
from repro_torch.convert import adamw_state_from_numpy, params_from_numpy
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import to_device, train_loop
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw_init

ROOT = Path(__file__).resolve().parents[1]
JRT = JL.Runtime(compute_dtype=jnp.float32)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4                 # of each leaf's largest magnitude
STEP_TOL = 1e-5
ILL = 10 * 1e-8                 # ten of AdamW's eps
B, S = 2, 16


def _trt(**kw):
    return TL.Runtime(compute_dtype=torch.float32, **kw)


def _batch(cfg, b=B, s=S, seed=5):
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.frontend == "vit_stub":
        batch["patch_embeds"] = r.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["frames"] = r.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pair(name, seed=1):
    """The reference's model and parameters, and the port's model with
    the same parameters."""
    jcfg, tcfg = jconfigs.get_smoke(name), tconfigs.get_smoke(name)
    jm = jsteps.build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed), JRT)
    return jcfg, tcfg, jm, jp, tsteps.build_model(tcfg), _np(tcfg, jp)


def _np(tcfg, tree):
    return params_from_numpy(tcfg, jax.tree.map(np.asarray, tree))


def _loss_and_grads(tm, tp, batch, rt):
    leaves, spec = pytree.tree_flatten(tp)
    wrt = [p.detach().requires_grad_() for p in leaves]
    loss = tm.loss(pytree.tree_unflatten(wrt, spec), batch, rt)
    return loss.detach(), torch.autograd.grad(loss, wrt)


def _zero_in_exact_arithmetic(name, path):
    return name == "whisper-medium" and path.endswith("['bk']")


def _hold_grads(name, got, want_tree):
    paths = pytree.tree_flatten_with_path(want_tree)[0]
    assert len(paths) == len(got)
    top = max(float(w.abs().max()) for _, w in paths)
    for (path, w), g in zip(paths, got):
        key = pytree.keystr(path)
        if _zero_in_exact_arithmetic(name, key):
            assert float(w.abs().max()) < 1e-6 * top, key
            assert float(g.abs().max()) < 1e-6 * top, key
            continue
        tol = GRAD_TOL * float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= tol, (key, err, tol)


# ------------------------------------------------------ loss and gradients

@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_loss_and_gradients_match_the_reference(name):
    """`loss` and its autograd gradients against `jax.value_and_grad` of
    the reference's `loss`, on converted params, for every arch."""
    jcfg, tcfg, jm, jp, tm, tp = _pair(name)
    batch = _batch(jcfg)
    jl, jg = jax.value_and_grad(
        lambda p: jm.loss(p, _jax_batch(batch), JRT))(jp)
    loss, grads = _loss_and_grads(tm, tp, to_device(batch, "cpu"), _trt())
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) / float(jl) - 1) <= LOSS_RTOL
    _hold_grads(name, grads, _np(tcfg, jg))


def test_loss_mask_and_vlm_prefix_are_the_references():
    """A `loss_mask` (its mean with the max(sum, 1) floor) on the VLM
    stub, whose patch prefix the loss slices away."""
    jcfg, tcfg, jm, jp, tm, tp = _pair("internvl2-1b")
    batch = _batch(jcfg)
    mask = np.random.default_rng(9).integers(0, 2, (B, S)).astype(np.int32)
    for m in (mask, np.zeros_like(mask)):
        want = jm.loss(jp, {**_jax_batch(batch),
                            "loss_mask": jnp.asarray(m)}, JRT)
        got = tm.loss(tp, {**to_device(batch, "cpu"),
                           "loss_mask": torch.from_numpy(m)}, _trt())
        assert abs(float(got) - float(want)) <= LOSS_RTOL * max(
            abs(float(want)), 1.0)


def test_cross_entropy_contracts_a_one_hot():
    """The label's logit comes from a one-hot in the logits' dtype and a
    batched product (the reference's einsum: its [B, S, V] tensor and its
    2 B S V FLOPs); the max is detached."""
    logits = torch.randn(2, 5, 64, dtype=torch.bfloat16, requires_grad=True)
    tok = torch.randint(0, 64, (2, 5))
    counts = tsteps.count_step(tlm.cross_entropy, logits, tok)[1]
    assert counts.flops_by_op == {"aten.bmm": 2 * 2 * 5 * 64}
    nll = tlm.cross_entropy(logits, tok)
    assert nll.dtype == torch.float32
    x = logits.detach().float()
    want = torch.logsumexp(x, -1) - x.gather(-1, tok[..., None])[..., 0]
    torch.testing.assert_close(nll.detach(), want, rtol=1e-6, atol=1e-5)
    g, = torch.autograd.grad(nll.sum(), logits)
    torch.testing.assert_close(
        g.float(), (torch.softmax(x, -1)
                    - torch.nn.functional.one_hot(tok, 64)).bfloat16()
        .float(), rtol=0, atol=2 ** -8)


# -------------------------------------------------------------------- remat

def test_units_are_the_references_scan_units():
    """`DecoderLM.units()` cuts the flat layer list where the reference's
    scan bodies are: one repeat of a group's pattern, a group of one
    repeat as a whole (deepseek's leading dense layer; recurrentgemma's
    pattern cut short at the end)."""
    from repro.models.lm import plan_groups as ref_groups
    for name in jconfigs.ARCH_NAMES:
        if jconfigs.get_arch(name).is_encdec:
            continue
        for get in ("get_smoke", "get_arch"):
            cfg = getattr(tconfigs, get)(name)
            want, i = [], 0
            for g in ref_groups(getattr(jconfigs, get)(name)):
                for _ in range(g.repeats):
                    want.append((i, len(g.unit)))
                    i += len(g.unit)
            model = tlm.DecoderLM(cfg)
            assert model.units() == want, (name, get)
            assert i == len(model.kinds) == cfg.num_layers


def _aten_counts(fn):
    """How many times each aten op ran in `fn()` (forward and backward)."""
    from collections import Counter
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[func.overloadpacket.__name__] += 1
            return func(*args, **(kwargs or {}))

    with Count() as c:
        fn()
    return c.n


@pytest.mark.parametrize("name", ["qwen2-0.5b", "recurrentgemma-9b",
                                  "olmoe-1b-7b", "whisper-medium"])
def test_remat_policies_give_the_same_loss_and_gradients(name):
    """`none`, `full` and `dots` give the same loss and gradients (bit for
    bit: the recompute repeats the forward's arithmetic).  `full`
    recomputes every forward product in the backward; `dots` recomputes
    the batched ones (`bmm`) and none of the `mm`/`addmm` it saves; the
    encoder-decoder recomputes under `full` only, as the reference."""
    jcfg, tcfg, jm, jp, tm, tp = _pair(name)
    batch = to_device(_batch(jcfg), "cpu")
    runs = {}
    for remat in ("none", "full", "dots"):
        out = {}

        def run(remat=remat):
            out["v"] = _loss_and_grads(tm, tp, batch, _trt(remat=remat))
        counts = _aten_counts(run)
        runs[remat] = (out["v"], counts)
    (l0, g0), n0 = runs["none"]
    for remat in ("full", "dots"):
        (l1, g1), n1 = runs[remat]
        assert torch.equal(l1, l0)
        assert all(torch.equal(a, b) for a, b in zip(g1, g0))
    mm = ("mm", "addmm")
    fwd_mm = sum(_aten_counts(lambda: tm.loss(tp, batch, _trt()))[k]
                 for k in mm)
    if tcfg.is_encdec:
        # whisper's layers are its scans' bodies: all but the embedding's
        # head recomputed under full, nothing under dots
        assert runs["dots"][1] == n0
        assert sum(runs["full"][1][k] for k in mm) > sum(n0[k] for k in mm)
        return
    # every layer's products recomputed under full (the LM head's is
    # outside the units; checkpoint's early stop skips a unit's last
    # product when no backward reads its output, as XLA drops it); under
    # dots no mm/addmm again, but the batched products are
    again = sum(runs["full"][1][k] - n0[k] for k in mm)
    units = len(tm.units())
    assert fwd_mm - 1 - units <= again <= fwd_mm - 1
    assert sum(runs["dots"][1][k] for k in mm) == sum(n0[k] for k in mm)
    assert runs["dots"][1]["bmm"] > n0["bmm"]
    assert runs["full"][1]["bmm"] >= runs["dots"][1]["bmm"]


# ---------------------------------------------------------- kernel guards

def _needs_grad(*tensors):
    return [t.detach().requires_grad_() for t in tensors]


def test_flash_branch_refuses_a_forward_that_needs_gradients():
    """Under `use_kernels` the flash kernel's output would carry no
    gradient to q, k and v: the branch raises when grad is on and an
    input needs it; without grad (serving) it runs."""
    tcfg = tconfigs.get_smoke("qwen2-0.5b")
    model = tlm.DecoderLM(tcfg)
    p = model.init(torch.Generator().manual_seed(0), _trt())["layers"][0]
    x = torch.randn(2, 8, tcfg.d_model)
    kw = dict(n_heads=tcfg.num_heads, n_kv=tcfg.num_kv_heads,
              hd=tcfg.resolved_head_dim, rope_theta=tcfg.rope_theta,
              rt=_trt(use_kernels=True))
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        TL.gqa_attention_train(p["attn"], *_needs_grad(x), **kw)
    with torch.no_grad():
        y = TL.gqa_attention_train(p["attn"], *_needs_grad(x), **kw)
    with torch.inference_mode():
        assert torch.equal(TL.gqa_attention_train(p["attn"], x, **kw), y)
    want = TL.gqa_attention_train(p["attn"], x, **{**kw, "rt": _trt()})
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)


def test_rglru_branch_refuses_a_forward_that_needs_gradients():
    """The same for the RG-LRU block's kernel `rglru_gated_scan`, whether
    the input or a parameter needs the gradient."""
    tcfg = tconfigs.get_smoke("recurrentgemma-9b")
    model = tlm.DecoderLM(tcfg)
    params = model.init(torch.Generator().manual_seed(0), _trt())
    p = params["layers"][model.kinds.index("rglru")]["rglru"]
    x = torch.randn(2, 8, tcfg.d_model)
    rt = _trt(use_kernels=True)
    with pytest.raises(RuntimeError, match="rglru_gated_scan has no back"):
        TL.rglru_block_train(p, *_needs_grad(x), n_heads=tcfg.num_heads,
                             rt=rt)
    p_grad = {**p, "a_param": p["a_param"].detach().requires_grad_()}
    with pytest.raises(RuntimeError, match="no backward"):
        TL.rglru_block_train(p_grad, x, n_heads=tcfg.num_heads, rt=rt)
    with torch.no_grad():
        y = TL.rglru_block_train(p_grad, x, n_heads=tcfg.num_heads, rt=rt)
    want = TL.rglru_block_train(p, x, n_heads=tcfg.num_heads, rt=_trt())
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ train steps

STEP_KW = dict(base_lr=1e-3, warmup_steps=2, total_steps=6)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("name", ["qwen2-0.5b", "olmoe-1b-7b",
                                  "whisper-medium"])
def test_train_steps_match_the_reference(name, microbatches):
    """Three steps of `make_train_step` against the reference's (jitted)
    from the same params and batches: loss, grad norm and lr each step,
    and every parameter and moment after the steps, within 1e-5.

    Adam's step m / (sqrt(v) + eps) is ill-conditioned where a gradient
    element is within a few eps of zero: there the gradients' rounding
    (1e-9 on a leaf of magnitude 0.04) moves the update by a fair part of
    the lr.  Elements whose reference gradient fell below 10 eps, and not
    to zero, at some step (`ILL`, under 1 % of them) are held to the lr's
    bound instead: each step moves them by at most lr (1 + decay) in both
    packages."""
    jcfg, tcfg, jm, jp, tm, tp = _pair(name)
    jstep = jax.jit(jsteps.make_train_step(jm, JRT, microbatches=microbatches,
                                           **STEP_KW))
    jgrad = jax.jit(jax.grad(lambda p, b: jm.loss(p, b, JRT)))
    tstep = tsteps.make_train_step(tm, _trt(), microbatches=microbatches,
                                   **STEP_KW)
    jstate, tstate = j_adamw_init(jp), adamw_init(tp)
    ill = [torch.zeros(p.shape, dtype=torch.bool)
           for p in pytree.tree_leaves(tp)]
    lr_sum = 0.0
    for step in range(3):
        batch = _batch(jcfg, b=4, seed=step)
        for i, g in enumerate(pytree.tree_leaves(_np(
                tcfg, jgrad(jp, _jax_batch(batch))))):
            ill[i] |= (g != 0) & (g.abs() < ILL)
        jp, jstate, jmet = jstep(jp, jstate, _jax_batch(batch))
        lr_sum += float(jmet["lr"])
        tp, tstate, tmet = tstep(tp, tstate, to_device(batch, "cpu"))
        for k in ("loss", "grad_norm", "lr"):
            assert tmet[k].dim() == 0 and tmet[k].dtype == torch.float32
            assert abs(float(tmet[k]) / float(jmet[k]) - 1) <= STEP_TOL, k
    assert int(tstate.step) == 3 and tstate.step.dtype == torch.int32
    n_ill = sum(int(m.sum()) for m in ill)
    assert n_ill <= 1e-2 * sum(m.numel() for m in ill)
    bound = lr_sum * (1 + 0.1 * 0.1) + STEP_TOL
    for got, want in ((tp, jp), (tstate.mu, jstate.mu),
                      (tstate.nu, jstate.nu)):
        for g, w, m in zip(pytree.tree_leaves(got),
                           pytree.tree_leaves(_np(tcfg, want)), ill):
            err = (g - w).abs()
            ok = err <= STEP_TOL + STEP_TOL * w.abs()
            if got is tp:
                ok |= m & (err <= bound)
            assert bool(ok.all()), float(err[~ok].max())


def test_train_step_continues_a_converted_reference_state():
    """`adamw_state_from_numpy` carries the reference's optimizer state
    across: a step taken from it in the port is the reference's next."""
    jcfg, tcfg, jm, jp, tm, tp = _pair("qwen2-0.5b")
    jstep = jax.jit(jsteps.make_train_step(jm, JRT, **STEP_KW))
    jstate = j_adamw_init(jp)
    jp, jstate, _ = jstep(jp, jstate, _jax_batch(_batch(jcfg, seed=0)))
    tp = _np(tcfg, jp)
    tstate = adamw_state_from_numpy(tcfg, jax.tree.map(np.asarray, jstate))
    assert int(tstate.step) == 1
    batch = _batch(jcfg, seed=1)
    jp, jstate, jmet = jstep(jp, jstate, _jax_batch(batch))
    tp, tstate, tmet = tsteps.make_train_step(tm, _trt(), **STEP_KW)(
        tp, tstate, to_device(batch, "cpu"))
    assert abs(float(tmet["lr"]) / float(jmet["lr"]) - 1) <= STEP_TOL
    for g, w in zip(pytree.tree_leaves(tp), pytree.tree_leaves(_np(tcfg, jp))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=STEP_TOL,
                                   atol=STEP_TOL)


def test_make_runtime_for_train_shapes_is_the_references():
    """fp32 params, bf16 compute, remat "full" by default (serving shapes
    no remat), as the reference's `make_runtime`."""
    cfg = tconfigs.get_arch("qwen2-0.5b")
    rt = tsteps.make_runtime(cfg, tconfigs.shape_by_name("train_4k"))
    assert (rt.param_dtype, rt.compute_dtype, rt.remat) == (
        torch.float32, torch.bfloat16, "full")
    assert tsteps.make_runtime(cfg, tconfigs.shape_by_name("train_4k"),
                               remat="dots").remat == "dots"
    assert tsteps.make_runtime(cfg, tconfigs.shape_by_name("prefill_32k"),
                               remat="full").remat == "none"
    assert TL.Runtime().remat == JL.Runtime().remat == "none"


# -------------------------------------------------------- the train loop

def test_train_loop_reduces_loss(tmp_path):
    """Twin of `tests/test_system.py::test_train_loop_reduces_loss`."""
    arch = tconfigs.get_smoke("qwen2-0.5b")
    res = train_loop(arch, steps=40, global_batch=8, seq_len=64,
                     ckpt_dir=str(tmp_path), save_every=20, lr=3e-3,
                     log_every=100, device="cpu")
    first = np.mean(res["losses"][:5])
    last = np.mean(res["losses"][-5:])
    assert np.isfinite(last)
    assert last < first - 0.05, (first, last)


def test_train_resume_continues(tmp_path):
    """Twin of `tests/test_system.py::test_train_resume_continues`, and
    the resumed losses equal the uninterrupted run's."""
    arch = tconfigs.get_smoke("qwen2-0.5b")
    kw = dict(global_batch=4, seq_len=32, log_every=100, device="cpu")
    train_loop(arch, steps=10, ckpt_dir=str(tmp_path / "a"), save_every=5,
               **kw)
    res = train_loop(arch, steps=14, ckpt_dir=str(tmp_path / "a"),
                     resume=True, **kw)
    assert len(res["losses"]) == 4        # resumed at step 10
    whole = train_loop(arch, steps=14, ckpt_dir=str(tmp_path / "b"),
                       save_every=7, **kw)
    import shutil
    shutil.rmtree(tmp_path / "b" / "step_14")
    again = train_loop(arch, steps=14, ckpt_dir=str(tmp_path / "b"),
                       resume=True, **kw)
    assert again["losses"] == whole["losses"][7:]


@pytest.mark.parametrize("name", ["internvl2-1b", "whisper-medium"])
def test_train_loop_feeds_the_extras(name):
    """The VLM stub's patch embeddings and the encoder-decoder's frames."""
    res = train_loop(tconfigs.get_smoke(name), steps=2, global_batch=2,
                     seq_len=24, log_every=100, device="cpu")
    assert len(res["losses"]) == 2 and np.isfinite(res["final_loss"])


def _cli(*args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)


def test_cli_trains_on_the_cpu_and_refuses_without_a_gpu(tmp_path):
    args = ["--arch", "qwen2-0.5b", "--smoke", "--steps", "3", "--batch",
            "2", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    done = _cli(*args, "--device", "cpu")
    assert done.returncode == 0, done.stderr
    assert re.search(r"\[train\] done: [\d.]+M params, loss ", done.stdout)
    assert (tmp_path / "step_3" / "manifest.json").exists()
    if not torch.cuda.is_available():
        refused = _cli(*args)
        assert refused.returncode != 0
        assert "torch.cuda.is_available() is False" in refused.stderr
