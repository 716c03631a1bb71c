"""The port's roofline report (repro_torch.launch.roofline), as
test_roofline.py checks the JAX package's: loading and ordering synthetic
dry-run records, the per-cell diagnosis branches, the rows_for table — whose
roofline_frac must derive from the H100's perfmodel_h100.PEAK_FLOPS, not a
local literal — and the roofline_terms helper of rung 1 (trace_analysis),
on the card's constants."""
import json

import pytest

from repro_torch.core.perfmodel_h100 import HBM_BW, PEAK_FLOPS
from repro_torch.launch.roofline import (CELL_ORDER, HEADER, diagnose, load, main,
                                         rows_for)
from repro_torch.launch.trace_analysis import NVLINK_BW, roofline_terms


def _rec(arch="gpt_1b", cell="train_4k", dominant="compute",
         compute=1e-3, memory=4e-4, collective=2e-4,
         coll_bytes=None, sites=None, model_flops=None, useful=0.62):
    return {
        "arch": arch, "cell": cell,
        "terms_s": {"compute": compute, "memory": memory,
                    "collective": collective},
        "dominant": dominant,
        "collectives": {"bytes": {} if coll_bytes is None else coll_bytes},
        "top_collective_sites": sites or [],
        "model_flops_per_chip": (PEAK_FLOPS * compute if model_flops is None
                                 else model_flops),
        "useful_flops_frac": useful,
    }


def _write(tmp_path, name, rec):
    (tmp_path / name).write_text(json.dumps(rec))


def test_load_filters_by_mesh_and_orders_by_arch_then_cell(tmp_path):
    _write(tmp_path, "b__decode_32k__pod1.json", _rec("b", "decode_32k"))
    _write(tmp_path, "a__prefill_32k__pod1.json", _rec("a", "prefill_32k"))
    _write(tmp_path, "a__train_4k__pod1.json", _rec("a", "train_4k"))
    _write(tmp_path, "a__weird__pod1.json", _rec("a", "not_a_cell"))
    _write(tmp_path, "a__train_4k__pod2.json", _rec("zzz", "train_4k"))
    recs = load("pod1", str(tmp_path))
    assert [(r["arch"], r["cell"]) for r in recs] == [
        ("a", "train_4k"), ("a", "prefill_32k"), ("a", "not_a_cell"),
        ("b", "decode_32k")]                  # unknown cells sort last per arch
    assert all(c in CELL_ORDER for c in ("train_4k", "prefill_32k",
                                         "decode_32k", "long_500k"))
    assert load("pod3", str(tmp_path)) == []


def test_diagnose_covers_each_dominant_branch():
    coll = {"all-reduce": 3e9, "all-gather": 1e9}
    sites = [["fused_allreduce_in_backward_pass_of_layer_0", 3e9]]
    d = diagnose(_rec(dominant="collective", coll_bytes=coll, sites=sites))
    assert "all-reduce" in d and "fused_allreduce" in d
    # no recorded sites: placeholder, not a crash
    assert "?" in diagnose(_rec(dominant="collective", coll_bytes=coll))
    assert "HBM-bound" in diagnose(_rec(cell="decode_32k", dominant="memory"))
    assert "cache" in diagnose(_rec(cell="long_500k", dominant="memory"))
    assert "activation" in diagnose(_rec(cell="train_4k", dominant="memory"))
    assert "tensor-core-bound" in diagnose(_rec(dominant="compute"))


def test_rows_for_roofline_frac_comes_from_shared_peak():
    """The ideal step time is model_flops / PEAK_FLOPS with the
    perfmodel_h100 constant — a cell whose bound term exactly equals that
    ideal reads 1.00, and scaling the bound halves the fraction."""
    at_peak = _rec(compute=2e-3, memory=1e-3, collective=1e-3,
                   model_flops=PEAK_FLOPS * 2e-3)
    half = _rec(compute=4e-3, memory=1e-3, collective=1e-3,
                model_flops=PEAK_FLOPS * 2e-3)
    rows = rows_for([at_peak, half])
    assert len(rows[0]) == len(HEADER)
    frac_col = HEADER.index("roofline_frac")
    assert rows[0][frac_col] == "1.00"
    assert rows[1][frac_col] == "0.50"
    assert rows[0][HEADER.index("dominant")] == "compute"


def test_rows_for_zero_bound_is_safe():
    rec = _rec(compute=0.0, memory=0.0, collective=0.0, model_flops=0.0)
    assert rows_for([rec])[0][HEADER.index("roofline_frac")] == "0.00"


def test_main_renders_synthetic_records(tmp_path, capsys):
    _write(tmp_path, "a__train_4k__pod1.json", _rec())
    main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "roofline_frac" in out and "dominant-term counts" in out
    main(["--dir", str(tmp_path), "--markdown"])
    assert capsys.readouterr().out.startswith("| arch |")
    with pytest.raises(FileNotFoundError):
        main(["--dir", str(tmp_path), "--mesh", "pod2"])


def test_roofline_terms_three_term_model():
    """The helper rung 1 of the evaluation cascade scores with: seconds per
    term from the same machine constants the launch report uses (NVLink for
    the collective term: rung 1 traces one card)."""
    summary = {"flops": PEAK_FLOPS * 1e-3, "bytes_accessed": HBM_BW * 2e-3,
               "collective_total_bytes": NVLINK_BW * 5e-4}
    t = roofline_terms(summary)
    assert t["compute"] == pytest.approx(1e-3)
    assert t["memory"] == pytest.approx(2e-3)
    assert t["collective"] == pytest.approx(5e-4)
    assert roofline_terms({}) == {"compute": 0.0, "memory": 0.0,
                                  "collective": 0.0}


def test_peak_is_the_h100s():
    assert PEAK_FLOPS == 989e12 and HBM_BW == 3.35e12
