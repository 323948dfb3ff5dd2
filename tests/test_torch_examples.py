"""The port's examples (`examples/torch_*.py`) against the JAX package's
(`examples/*.py`): each DSE twin, run with ``--device cpu``, prints the
reference example's stdout for the same arguments; the training twin its
lines with the losses of its own random model.

One part differs by design: the quickstart's part 3 prints the port's
tile pick for an H100 (held here to `tune_matmul_tiles`).
`torch_trace_model.py` prints the reference's summary line for line, its
count of data vertices (`data_nodes=`) included.  The runs of the module
fixture go at once.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import apps
from repro_torch.core.kernel_tune import H100_TC_TILES, tune_matmul_tiles
from repro_torch.frontend.zoo import PORTED_ARCHS

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
CASES = {
    "quickstart": [],
    "dse_accelerator": ["--engine", "greedy"],
    "compose_serving": ["--smoke"],
    "trace_model": [],
}
DATA_NODES = re.compile(r"data_nodes=(\d+)")


def start(script, args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    return subprocess.Popen([sys.executable, str(EXAMPLES / script), *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)


def finish(proc):
    out, err = proc.communicate(timeout=300)
    return proc.returncode, out, err


@pytest.fixture(scope="module")
def outputs():
    procs = {n: (start(f"{n}.py", a),
                 start(f"torch_{n}.py", [*a, "--device", "cpu"]))
             for n, a in CASES.items()}
    out = {}
    for n, (ref, twin) in procs.items():
        (rc_r, out_r, err_r), (rc_t, out_t, err_t) = finish(ref), \
            finish(twin)
        assert rc_r == 0, err_r
        assert rc_t == 0, err_t
        out[n] = (out_r, out_t, err_t)
    return out


@pytest.mark.parametrize("name", ["dse_accelerator", "compose_serving"])
def test_twin_prints_the_reference_stdout(name, outputs):
    ref, twin, err = outputs[name]
    assert twin == ref
    # the launches go to stderr only, none on the CPU
    assert err.strip().splitlines()[-1] == "gather_rows launches: 0"


def test_quickstart_parts_1_and_2_are_the_references(outputs):
    ref, twin, _ = outputs["quickstart"]
    r, t = ref.splitlines(), twin.splitlines()
    assert len(r) == len(t) == 6
    assert t[:5] == r[:5]
    assert "v5e" in r[5] and "VMEM" in r[5]


def test_quickstart_part_3_is_the_h100_tile_pick(outputs):
    line = outputs["quickstart"][1].splitlines()[5]
    best, cost, _ = tune_matmul_tiles(8192, 8192, 8192, chip=H100_TC_TILES)
    bound = "compute" if cost["compute_s"] >= cost["memory_s"] else "memory"
    assert line == (
        f"H100 matmul tile DSE (8k^3 bf16): best tile "
        f"(bm,bk,bn)=({best.bm},{best.bk},{best.bn}) -> "
        f"{cost['latency_s'] * 1e3:.2f} ms predicted by the tile model for "
        f"an H100, not measured ({bound}-bound, shared memory "
        f"{cost['smem_bytes'] / 2 ** 10:.0f} KiB)")
    assert "v5e" not in line and "VMEM" not in line and "TPU" not in line


def test_trace_model_summary_is_the_references(outputs):
    """Every line equal, the data-vertex counts included."""
    ref, twin, _ = outputs["trace_model"]
    assert twin == ref
    counts = [int(n) for n in DATA_NODES.findall(twin)]
    assert counts == [apps.build_app(a).summary()["n_data_nodes"]
                      for a in ("qwen2-0.5b:prefill", "qwen2-0.5b:decode")]
    assert counts == [1327, 895]


def test_trace_model_lists_every_app():
    """The port's `--list` is the reference's, line for line: all twenty
    zoo apps of the ten archs, none marked."""
    (rc_r, ref, _), (rc_t, twin, _) = (
        finish(start("trace_model.py", ["--list"])),
        finish(start("torch_trace_model.py", ["--list"])))
    assert rc_r == rc_t == 0
    assert twin == ref
    zoo = [ln for ln in twin.splitlines() if ":" in ln]
    assert len(zoo) == 20 and "not ported" not in twin
    assert {ln.partition(":")[0] for ln in zoo} == set(PORTED_ARCHS)


def test_trace_model_traces_whisper_decode():
    """The encoder-decoder's decode app prints the reference's summary,
    its data vertices included."""
    args = ["--app", "whisper-medium:decode"]
    (rc_r, ref, _), (rc_t, twin, err) = (
        finish(start("trace_model.py", args)),
        finish(start("torch_trace_model.py", [*args, "--device", "cpu"])))
    assert rc_r == rc_t == 0, err
    assert twin == ref and "whisper-medium:decode:" in twin
    assert [int(n) for n in DATA_NODES.findall(twin)] == [
        apps.build_app("whisper-medium:decode").summary()["n_data_nodes"]]


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_defaults_to_cuda(name):
    """Without a GPU a twin run without ``--device`` fails; it never
    carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the run without a GPU")
    if name == "trace_model":          # its default run searches nothing
        args = ["--optimize", "--app", "ptb"]
    else:
        args = CASES[name]
    rc, _, err = finish(start(f"torch_{name}.py", args))
    assert rc != 0
    assert "torch.cuda.is_available() is False" in err


NUMBER = re.compile(r"-?\d+\.\d+(?:e[+-]\d+)?")
TIMING = re.compile(r"\(\d+\.\ds\)")


def test_train_lm_twin_prints_the_reference_lines(tmp_path):
    """`torch_train_lm.py --device cpu` prints the reference example's
    lines (timings masked): the same steps logged, the same parameter
    count and step count in the summary.  The parameters come from a
    `torch.Generator`, so the losses are not the reference's: each logged
    loss is held within 0.05 of the reference's (both start at ln V of a
    random model and learn the same Markov stream), and the run learns."""
    args = ["--steps", "8", "--batch", "4", "--seq", "32", "--lr", "3e-3"]
    (rc_r, ref, err_r), (rc_t, twin, err_t) = (
        finish(start("train_lm.py", [*args, "--ckpt-dir",
                                     str(tmp_path / "r")])),
        finish(start("torch_train_lm.py", [*args, "--ckpt-dir",
                                           str(tmp_path / "t"),
                                           "--device", "cpu"])))
    assert rc_r == 0, err_r
    assert rc_t == 0, err_t
    r = TIMING.sub("(t)", ref.replace(str(tmp_path / "r"), "DIR"))
    t = TIMING.sub("(t)", twin.replace(str(tmp_path / "t"), "DIR"))
    assert NUMBER.sub("x", t) == NUMBER.sub("x", r)
    assert t.splitlines()[-1].split(" | ")[0] == \
        r.splitlines()[-1].split(" | ")[0]            # the params
    assert " over 8 steps | checkpoints in DIR" in t
    loss = re.compile(r"loss=\s*([\d.]+)")
    got = [float(x) for x in loss.findall(t)]
    want = [float(x) for x in loss.findall(r)]
    assert len(got) == len(want) == 2
    assert all(abs(g - w) <= 0.05 for g, w in zip(got, want))
    assert (tmp_path / "t" / "step_8" / "manifest.json").exists()


def test_train_lm_twin_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the run without a GPU")
    rc, _, err = finish(start("torch_train_lm.py", [
        "--steps", "1", "--ckpt-dir", str(tmp_path)]))
    assert rc != 0
    assert "torch.cuda.is_available() is False" in err


def test_serve_lm_twin_prints_the_reference_request_lines():
    """`torch_serve_lm.py --device cpu` at the reference example's flags:
    the summary line (timings masked) and every request line equal.  The
    twin's weights come from a `torch.Generator`, the reference's from
    `PRNGKey(seed)`; a random smoke model with tied embeddings still
    greedily repeats each prompt's last token, so the lines agree on
    different weights (the next test holds the tokens on the same
    weights)."""
    (rc_r, ref, err_r), (rc_t, twin, err_t) = (
        finish(start("serve_lm.py", [])),
        finish(start("torch_serve_lm.py", ["--device", "cpu"])))
    assert rc_r == 0, err_r
    assert rc_t == 0, err_t
    r, t = ref.splitlines(), twin.splitlines()
    assert len(t) == len(r) == 11
    assert NUMBER.sub("x", t[0]) == NUMBER.sub("x", r[0])
    assert t[0].startswith("10 requests, 120 tokens, ")
    assert t[1:] == r[1:]


def test_serve_lm_tokens_are_the_references_on_its_weights():
    """The twin's prompts and loop (`serve_requests` at the example's
    defaults: 10 requests, pool 4, 12 new tokens, seed 0) handed the
    reference's `model.init(PRNGKey(0))` weights (`params_from_numpy`)
    generate the reference's `serve_requests` tokens."""
    import jax
    import numpy as np

    from repro import configs as jconfigs
    from repro.launch import serve as jserve
    from repro.launch.steps import build_model as jbuild
    from repro.models.layers import Runtime as JRuntime
    from repro_torch import configs as tconfigs
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import serve as tserve

    jcfg, tcfg = (jconfigs.get_smoke("qwen2-0.5b"),
                  tconfigs.get_smoke("qwen2-0.5b"))
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, tcfg.vocab_size,
                                          size=int(rng.integers(4, 16)))))
               for _ in range(10)]
    want = jserve.serve_requests(jcfg, prompts, batch=4, max_new=12,
                                 seed=0)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0),
                           JRuntime(compute_dtype=np.float32))
    got = tserve.serve_requests(
        tcfg, prompts, batch=4, max_new=12, device="cpu",
        params=params_from_numpy(tcfg, jax.tree.map(np.asarray, jp)))
    assert [r.request_id for r in got] == list(range(10))
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(len(r.generated) == 12 for r in got)


def test_serve_lm_twin_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the run without a GPU")
    rc, _, err = finish(start("torch_serve_lm.py", ["--requests", "1"]))
    assert rc != 0
    assert "torch.cuda.is_available() is False" in err
