"""The port's serial evolution vs the JAX package's, and the port's import
hygiene: it imports no JAX and nothing of the JAX package."""
import json
import os
import pathlib
import re
import subprocess
import sys

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np

from repro.core import ContinuousEvolution as JaxContinuousEvolution
from repro.core import Scorer as JaxScorer
from repro.core.perfmodel import BenchConfig as JaxBenchConfig
from repro.core.population import Lineage as JaxLineage
from repro_torch.core.evals import InlineBackend
from repro_torch.core.evolution import ContinuousEvolution
from repro_torch.core.perfmodel import BenchConfig
from repro_torch.core.population import Lineage

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
STEPS = 6

# the two-config suite of tests/test_core_search.py
FAST = [("c4k", 8, 16, 16, 4096, True), ("n4k", 8, 16, 16, 4096, False)]


def _commits(lineage):
    return [(c.genome.key(), c.geomean, c.values, c.note) for c in lineage.commits]


def test_lineage_matches_jax(tmp_path):
    """Same operator seed, same suite, rung 0: both packages commit the same
    genomes with the same geomeans, step for step."""
    ours = ContinuousEvolution(scorer=InlineBackend(
        suite=[BenchConfig(n, b, h, kv, s, causal=c) for n, b, h, kv, s, c in FAST],
        device="cpu"))
    theirs = JaxContinuousEvolution(scorer=JaxScorer(
        suite=[JaxBenchConfig(n, b, h, kv, s, causal=c) for n, b, h, kv, s, c in FAST]))
    rep = ours.run(max_steps=STEPS)
    ref = theirs.run(max_steps=STEPS)
    assert rep.steps == ref.steps == STEPS
    assert rep.commits == ref.commits > 1
    assert _commits(ours.lineage) == _commits(theirs.lineage)
    assert [t["note"] for t in rep.traces] == [t["note"] for t in ref.traces]

    # a lineage the JAX package persisted loads unchanged in the port
    path = tmp_path / "lineage_mha.json"
    theirs.lineage.save(str(path))
    loaded = Lineage.load(str(path))
    assert _commits(loaded) == _commits(theirs.lineage)
    assert loaded.to_payload() == json.loads(path.read_text())
    # and the port's file loads in the JAX package
    ours.lineage.save(str(tmp_path / "ours.json"))
    assert _commits(JaxLineage.load(str(tmp_path / "ours.json"))) == \
        _commits(ours.lineage)


def test_resume_continues_the_lineage(tmp_path):
    path = str(tmp_path / "lineage.json")
    suite = [BenchConfig(n, b, h, kv, s, causal=c) for n, b, h, kv, s, c in FAST]
    evo = ContinuousEvolution(scorer=InlineBackend(suite=suite, device="cpu"),
                              persist_path=path)
    evo.run(max_steps=2)
    n = len(evo.lineage)
    assert n >= 1 and os.path.exists(path)
    again = ContinuousEvolution.resume(
        path, scorer=InlineBackend(suite=suite, device="cpu"))
    assert _commits(again.lineage) == _commits(evo.lineage)
    assert np.isfinite(again.lineage.best().geomean)


def test_import_pulls_in_no_jax_and_no_reference_package():
    code = ("import sys, repro_torch.core.evolution, repro_torch.evolve, "
            "repro_torch.kernels.flash_attention, repro_torch.kernels._build, "
            "repro_torch.kernels.flash_decode, repro_torch.kernels.ssd, "
            "repro_torch.kernels.ops, repro_torch.kernels.ref, "
            "repro_torch.configs, repro_torch.configs.registry, "
            "repro_torch.models, repro_torch.models.convert, "
            "repro_torch.launch.serve, repro_torch.serve; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.')); print(bad)")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_source_scan_finds_no_jax_and_no_reference_imports():
    bad = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.]|import\s+repro(\s|\.|$)"
                     r"|from\s+repro[\s.])", re.M)
    files = list((SRC / "repro_torch").rglob("*.py"))
    assert len(files) > 10
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in bad.finditer(f.read_text())]
    assert hits == []
    smoke = SRC.parent / "chip_smoke.py"
    assert not bad.search(smoke.read_text())
