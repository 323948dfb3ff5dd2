"""The port stands alone: no source file of `src/repro_torch/` (nor
`chip_smoke.py`) imports jax or the JAX package, and its CPU main paths
(the DSE study, the zoo's traced apps and the model server) run without
either in `sys.modules`."""

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
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
