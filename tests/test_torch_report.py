"""The port's journal report (``repro_torch.core.obs.report``) on the CPU: a
journal written by a port run (a frontier job on spawned CPU workers, the
telemetry plane on) reads the same through the port's ``summarize`` /
``render`` as through the JAX package's; and a smoke run of
``examples/search_service_torch.py --device cpu`` at a small budget."""
import importlib.util
import io
import pathlib

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)

from repro.core.obs import report as jax_report
from repro_torch.core import SearchFrontier, SearchJob, obs
from repro_torch.core.obs import report
from repro_torch.core.perfmodel import (BenchConfig, register_suite,
                                        unregister_suite)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAST_SUITE = [BenchConfig("c4k", 8, 16, 16, 4096, causal=True),
              BenchConfig("n4k", 8, 16, 16, 4096, causal=False)]


def _render(mod, events, **kw) -> str:
    out = io.StringIO()
    mod.render(events, out=out, **kw)
    return out.getvalue()


def test_report_of_a_port_journal_equals_the_reference_report(tmp_path, capsys):
    prev = obs.enabled()
    obs.set_enabled(True)
    obs.BUS.ring.clear()
    register_suite("report-fast", lambda: FAST_SUITE, overwrite=True)
    try:
        path = obs.ensure_journal(run_id="t-port-report", root=str(tmp_path))
        frontier = SearchFrontier(workers=1, device="cpu", worker_timeout_s=300.0)
        try:
            job_id = frontier.submit(SearchJob(suite="report-fast", steps=2,
                                               migration_interval=1, n_islands=2,
                                               device="cpu"))
            assert frontier.wait(job_id, timeout=600) == "done"
        finally:
            frontier.close()
    finally:
        obs.close_journal()
        obs.set_enabled(prev)
        obs.BUS.ring.clear()
        unregister_suite("report-fast")

    events = report.load_journal(path)
    assert events == jax_report.load_journal(path)
    ours = report.summarize(events)
    assert ours == jax_report.summarize(events)
    assert ours["tenants"][job_id]["job_event"] >= 4   # accepted ... done
    assert sum(row["commits"] for row in ours["islands"].values()) >= 2
    assert ours["traces"] > 0
    for kw in ({}, {"limit": 3}, {"trace": next(iter(report._by_trace(events)))},
               {"trace": "nope"}):
        assert _render(report, events, **kw) == _render(jax_report, events, **kw)
    assert report.main([str(path), "--limit", "2"]) == 0
    assert job_id in capsys.readouterr().out
    assert report.main([str(tmp_path / "nope.jsonl")]) == 2


def test_search_service_example_rehearses_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "search_service_torch", ROOT / "examples" / "search_service_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    st = example.main(["--device", "cpu", "--workers", "2", "--steps", "2",
                       "--budget", "6"])
    out = capsys.readouterr().out
    assert out.count("] done:") == 2, out
    tenants = st["coordinator"]["tenants"]
    assert len(tenants) == 2 and all(t["granted"] > 0 and t["completed"] == t["granted"]
                                     for t in tenants.values())
    assert all(j["status"] == "done" and j["spent"] > 0 for j in st["jobs"].values())
