"""The port stands alone: no source file of `src/repro_torch/` (nor
`chip_smoke.py`, nor the port's examples `examples/torch_*.py`) imports
jax or the JAX package, or PyTorch's test internals
(`torch.testing._internal`), and its CPU main paths (the DSE study, the
zoo's traced apps, the analysis API's table pass, the model servers, the
encoder-decoder's included, training: the train loop with its data,
optimizer and checkpoints, and a train cell's dry-run; and the meshes and
placements) run without either in `sys.modules`."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# `import jax`, `from jax...`, `import repro`, `from repro...`; the module
# name must end there, so `repro_torch` does not match
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|,|$)", re.MULTILINE)


def sources():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("torch_*.py")))


def test_scan_matches_only_whole_module_names():
    assert FORBIDDEN.search("import jax\n")
    assert FORBIDDEN.search("    from repro.core import apps\n")
    assert FORBIDDEN.search("import repro, os\n")
    assert not FORBIDDEN.search("from repro_torch.core import apps\n")
    assert not FORBIDDEN.search("import jaxlib_free_module\n")


@pytest.mark.parametrize("path", sources(), ids=lambda p: p.name)
def test_no_jax_or_repro_import_in_source(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def _run(code, cwd=ROOT):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=cwd, timeout=120)


def test_cpu_main_path_loads_neither_jax_nor_repro():
    """The DSE study on a paper app, and a zoo study over traced apps."""
    proc = _run(
        "import sys\n"
        "from repro_torch.core.apps import build_app\n"
        "from repro_torch.dse import Study, SearchBudget\n"
        "r = Study(apps=['resnet'], engine='greedy', device='cpu',\n"
        "          budget=SearchBudget.smoke()).run()\n"
        "assert r.best_score > 0\n"
        "assert len(build_app('qwen2-0.5b:prefill').op_stream()) == 217\n"
        "z = Study(apps=['qwen2-0.5b:prefill', 'recurrentgemma-9b:decode'],\n"
        "          engine='greedy', device='cpu',\n"
        "          budget=SearchBudget.smoke()).run()\n"
        "assert z.best_score > 0\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'repro', 'jaxlib'}))\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_cpu_parallel_study_loads_neither_jax_nor_repro():
    """A workers=2 study (spawned pool workers) and a composition."""
    proc = _run(
        "import os, sys\n"
        "from repro_torch.dse import Study, SearchBudget\n"
        "s = Study(apps=['ptb', 'wdl'], engine='greedy', device='cpu',\n"
        "          budget=SearchBudget.smoke(), workers=2)\n"
        "assert s.run().best_score > 0\n"
        "tasks = s.launch_stats['tasks']\n"
        "assert tasks and all(t['pool'] and t['pid'] != os.getpid()\n"
        "                     for t in tasks)\n"
        "c = Study(apps=['ptb', 'wdl'], composition=2, device='cpu',\n"
        "          budget=SearchBudget.smoke()).run()\n"
        "assert c.best.k == 2\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'repro', 'jaxlib'}))\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_scan_covers_obs_and_the_analysis_modules():
    names = {p.relative_to(PORT).as_posix() for p in sources()
             if PORT in p.parents}
    assert {"obs/__init__.py", "obs/trace.py", "obs/metrics.py",
            "obs/journal.py", "obs/oblog.py", "obs/attribution.py",
            "obs/validate.py", "core/sensitivity.py",
            "dse/parallel.py", "dse/composition.py",
            "core/search/partition.py"} <= names


def test_cpu_pareto_obs_radar_path_loads_neither_jax_nor_repro(tmp_path):
    """A Pareto study with telemetry, `explain` and the radar."""
    proc = _run(
        "import sys\n"
        "from repro_torch import obs\n"
        "from repro_torch.core.sensitivity import radar_of_top_configs\n"
        "from repro_torch.dse import (ParetoObjective, SearchBudget,\n"
        "                             Study)\n"
        "from repro_torch.obs.validate import main as validate\n"
        "obs.enable(trace=True, metrics=True, journal=True)\n"
        "s = Study(apps=['ptb', 'wdl'], objective=ParetoObjective(),\n"
        "          engine='genetic', device='cpu',\n"
        "          budget=SearchBudget(restarts=1, max_rounds=3,\n"
        "                              engine_kwargs={'population': 8}),\n"
        "          area_budgets=(30000.0, 60000.0, 90000.0))\n"
        "r = s.run()\n"
        "assert r.front and 'telemetry' in r.meta\n"
        f"obs.tracer().write(r'{tmp_path}/t.json')\n"
        f"obs.journal().write_jsonl(r'{tmp_path}/j.jsonl')\n"
        f"assert validate(['--trace', r'{tmp_path}/t.json',\n"
        f"                 '--journal', r'{tmp_path}/j.jsonl']) == 0\n"
        "assert s._evaluators[0].explain(r.best).ops\n"
        "rad = radar_of_top_configs('ptb', s.specs[0], s.space, k=2,\n"
        "                           restarts=1, max_rounds=2, device='cpu')\n"
        "assert rad.n_configs > 0\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'repro', 'jaxlib'}))\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_scan_covers_the_port_examples():
    names = {p.name for p in sources() if p.parent == ROOT / "examples"}
    assert names == {"torch_quickstart.py", "torch_dse_accelerator.py",
                     "torch_compose_serving.py", "torch_trace_model.py",
                     "torch_train_lm.py", "torch_serve_lm.py"}


def test_cpu_table_pass_loads_neither_jax_nor_repro():
    """The analysis API's default pass, its table route and its broadcast
    route, and `performance_gops` over it."""
    proc = _run(
        "import sys\n"
        "from repro_torch.core import costmodel as cm\n"
        "from repro_torch.core.multiapp import AppSpec\n"
        "from repro_torch.core.space import default_space\n"
        "import numpy as np\n"
        "sp = default_space()\n"
        "spec = AppSpec.from_app('inception')\n"
        "b = sp.decode_batch(sp.sample_indices(np.random.default_rng(0),\n"
        "                                      300))\n"
        "got = cm.evaluate_stream_many(b, spec.stream, sp.hw, device='cpu')\n"
        "want = cm.evaluate_stream_many(b, spec.stream, sp.hw,\n"
        "                               backend='numpy-ref')\n"
        "assert all(np.array_equal(got[2][k], want[2][k]) for k in want[2])\n"
        "cm.performance_gops(b[:10], spec.stream, sp.hw, device='cpu')\n"
        "assert dict(cm.PASSES) == {'tables': 1, 'numpy-ref': 1,\n"
        "                           'broadcast': 1}, cm.PASSES\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'repro', 'jaxlib'}))\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_cpu_serve_path_loads_neither_jax_nor_repro():
    proc = _run(
        "import sys\n"
        "from repro_torch import configs\n"
        "from repro_torch.launch.serve import serve_requests\n"
        "r = serve_requests(configs.get_smoke('qwen2-0.5b'), [[1, 2, 3]],\n"
        "                   batch=1, max_new=3, max_len=16, device='cpu')\n"
        "assert len(r[0].generated) == 3\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'repro', 'jaxlib'}))\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_cpu_recurrent_serve_path_loads_neither_jax_nor_repro():
    proc = _run(
        "import sys\n"
        "from repro_torch import configs\n"
        "from repro_torch.launch.serve import serve_requests\n"
        "r = serve_requests(configs.get_smoke('recurrentgemma-9b'),\n"
        "                   [[1, 2, 3]], batch=1, max_new=3, max_len=16,\n"
        "                   device='cpu')\n"
        "assert len(r[0].generated) == 3\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'repro', 'jaxlib'}))\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_cpu_encdec_paths_load_neither_jax_nor_repro():
    """whisper's `EncDecLM` (the scanned modules: `models/encdec.py` is in
    the source scan) served, and its two zoo apps traced."""
    assert PORT / "models" / "encdec.py" in sources()
    proc = _run(
        "import sys\n"
        "from repro_torch import configs\n"
        "from repro_torch.core.apps import build_app\n"
        "from repro_torch.launch.serve import serve_requests\n"
        "r = serve_requests(configs.get_smoke('whisper-medium'), [[1, 2]],\n"
        "                   batch=1, max_new=3, max_len=16, device='cpu')\n"
        "assert len(r[0].generated) == 3\n"
        "for v in ('prefill', 'decode'):\n"
        "    assert build_app(f'whisper-medium:{v}').summary()['n_ops']\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'repro', 'jaxlib'}))\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    """Without CUDA it exits non-zero and prints no result line."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, cwd=tmp_path,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_cpu_dry_run_loads_neither_jax_nor_repro(tmp_path):
    proc = _run(
        "import sys\n"
        "from repro_torch import configs\n"
        "from repro_torch.core.autotune import CellEvaluator, ExecPoint\n"
        "from repro_torch.core.kernel_tune import tune_matmul_tiles\n"
        "from repro_torch.kernels.matmul import matmul\n"
        "from repro_torch.launch import dryrun\n"
        "import torch\n"
        "dryrun.configs.get_arch = configs.get_smoke\n"
        f"ev = CellEvaluator('qwen2-0.5b', 'decode_32k', r'{tmp_path}',\n"
        "                   device='cpu')\n"
        "assert ev.score(ExecPoint()) > 0\n"
        "t, _, _ = tune_matmul_tiles(100, 200, 300)\n"
        "x, y = torch.ones((100, 200)), torch.ones((200, 300))\n"
        "assert matmul(x, y, bm=t.bm, bk=t.bk, bn=t.bn).shape == (100, 300)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'repro', 'jaxlib'}))\n")
    assert proc.returncode == 0, proc.stderr
    # run_cell prints one summary line first
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_scan_covers_the_training_modules():
    names = {p.relative_to(PORT).as_posix() for p in sources()
             if PORT in p.parents}
    assert {"optim/__init__.py", "optim/adamw.py", "optim/schedule.py",
            "data/__init__.py", "data/pipeline.py",
            "checkpoint/__init__.py", "checkpoint/manager.py",
            "launch/train.py", "launch/steps.py",
            "launch/dryrun.py"} <= names


def test_cpu_train_path_loads_neither_jax_nor_repro(tmp_path):
    """The train loop (data pipeline, train step under remat and
    microbatches, AdamW, checkpoints and a resume), an encoder-decoder's
    train step, and the dry-run of a train cell."""
    proc = _run(
        "import sys\n"
        "from repro_torch import configs\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.launch.train import train_loop\n"
        "arch = configs.get_smoke('qwen2-0.5b')\n"
        f"kw = dict(global_batch=4, seq_len=16, ckpt_dir=r'{tmp_path}/ck',\n"
        "          log_every=100, device='cpu', microbatches=2)\n"
        "train_loop(arch, steps=4, save_every=2, **kw)\n"
        "r = train_loop(arch, steps=6, resume=True, **kw)\n"
        "assert len(r['losses']) == 2\n"
        "w = train_loop(configs.get_smoke('whisper-medium'), steps=1,\n"
        "               global_batch=2, seq_len=8, device='cpu')\n"
        "assert len(w['losses']) == 1\n"
        "dryrun.configs.get_arch = configs.get_smoke\n"
        f"rec = dryrun.run_cell('qwen2-0.5b', 'train_4k', r'{tmp_path}',\n"
        "                       device='cpu')\n"
        "assert rec['status'] == 'OK', rec\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'repro', 'jaxlib'}))\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


# `import torch.testing._internal...` or `from torch.testing._internal...`
TEST_INTERNALS = re.compile(
    r"^\s*(?:import|from)\s+torch\.testing\._internal\b", re.MULTILINE)


def test_no_source_imports_torch_test_internals():
    assert TEST_INTERNALS.search(
        "from torch.testing._internal.distributed.fake_pg import FakeStore")
    assert not TEST_INTERNALS.search("import torch.testing\n")
    hits = [p.relative_to(ROOT).as_posix() for p in sources()
            if TEST_INTERNALS.search(p.read_text())]
    assert not hits, hits


def test_scan_covers_the_mesh_modules():
    names = {p.relative_to(PORT).as_posix() for p in sources()
             if PORT in p.parents}
    assert {"distributed/__init__.py", "distributed/sharding.py",
            "launch/mesh.py", "launch/elastic.py"} <= names


def test_cpu_mesh_and_placements_load_neither_jax_nor_repro():
    """A fake 16x16 mesh, qwen2-0.5b's step placements on it, smoke
    params placed on a 2x4 mesh, and the elastic coordinator."""
    proc = _run(
        "import sys\n"
        "import torch\n"
        "import torch.distributed as dist\n"
        "from torch.testing._internal.distributed.fake_pg import FakeStore\n"
        "from repro_torch import configs\n"
        "from repro_torch.launch import elastic\n"
        "from repro_torch.launch.mesh import make_mesh, make_production_mesh\n"
        "from repro_torch.launch.steps import (build_model, make_runtime,\n"
        "                                      place_params, step_placements)\n"
        "from repro_torch.models.layers import Runtime\n"
        "dist.init_process_group('fake', store=FakeStore(), rank=0,\n"
        "                        world_size=256)\n"
        "mesh = make_production_mesh(device_type='cpu')\n"
        "for s in configs.SHAPES:\n"
        "    step_placements(configs.get_arch('qwen2-0.5b'), s, mesh)\n"
        "    assert make_runtime(configs.get_arch('qwen2-0.5b'), s,\n"
        "                        mesh=mesh).rules is not None\n"
        "small = make_mesh((2, 4), ('data', 'model'), 'cpu')\n"
        "cfg = configs.get_smoke('qwen2-0.5b')\n"
        "sp = step_placements(cfg, configs.shape_by_name('prefill_32k'),\n"
        "                     small)\n"
        "p = build_model(cfg).init(torch.Generator().manual_seed(0),\n"
        "                          Runtime())\n"
        "placed = place_params(p, small, sp.inputs[0])\n"
        "assert placed['embed'].to_local().shape[0] * 4 == \\\n"
        "    p['embed'].shape[0]\n"
        "dist.destroy_process_group()\n"
        "assert elastic.valid_data_parallel(240, 16, 256) == 8\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'repro', 'jaxlib'}))\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_cpu_mesh_dry_run_loads_neither_jax_nor_repro(tmp_path):
    """A mesh cell's dry-run (its own fake group of 256 ranks, the step on
    DTensors, counted per rank) and the mesh-aware autotune's score."""
    proc = _run(
        "import sys\n"
        "from repro_torch import configs\n"
        "from repro_torch.core.autotune import CellEvaluator, ExecPoint\n"
        "from repro_torch.launch import dryrun\n"
        "dryrun.configs.get_arch = configs.get_smoke\n"
        f"rec = dryrun.run_cell('qwen2-0.5b', 'prefill_32k', r'{tmp_path}',\n"
        "                      multi_pod=False, device='cpu')\n"
        "assert rec['status'] == 'OK' and rec['chips'] == 256\n"
        "assert rec['roofline']['collective_bytes_per_chip'] > 0\n"
        f"ev = CellEvaluator('qwen2-0.5b', 'decode_32k', r'{tmp_path}',\n"
        "                   device='cpu', multi_pod=True)\n"
        "assert ev.score(ExecPoint(sharding_mode='tp', remat='none')) > 0\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'repro', 'jaxlib'}))\n")
    assert proc.returncode == 0, proc.stderr
    # run_cell prints its summary lines first
    assert proc.stdout.strip().splitlines()[-1] == "[]"
