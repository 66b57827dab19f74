"""The port's merged-trace report (``repro_torch.obs.report``) on traced
worlds of the port's pRUN, against the reference's report.

* ``traced_ring`` on 3 ``shm`` ranks and ``traced_all_pairs`` on 4
  ``hier`` ranks over 2 virtual nodes, each with ``trace=True``: the
  merged Chrome trace holds every rank, is valid under the port's schema
  (the reference's bytes), and ``summarize``, ``print_report`` and the
  CLI (``python -m repro_torch.obs.report --validate``) give what the
  reference's do on the same file.  The hier trace shows both fabrics
  and the two-level collectives.
* ``validate`` reports the reference's violations on a broken document.
"""

import copy
import io
import json
import os
import subprocess
import sys

import pytest

from _torch_prun import REPO, isolated, private_tmp, shm_parent, world_env  # noqa: F401
from repro.obs import report as ref_report
from repro_torch.launch import pRUN
from repro_torch.obs import report

WORLDS = {"ring_shm": ("traced_ring", "shm", 3, {}),
          "all_pairs_hier": ("traced_all_pairs", "hier", 4, {"nodes": 2})}


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_a_traced_world_reports_as_the_reference(name, tmp_path, shm_parent):
    body, transport, np_, kw = WORLDS[name]
    res = pRUN(f"repro_torch.obs._selftest:{body}", np_, transport=transport, trace=True,
               timeout=120, env=world_env(transport, shm_parent, PPYTHON_TRACE_DIR=tmp_path),
               **kw)
    assert len(res) == np_ and len(set(res)) == 1
    (path,) = tmp_path.glob("ppython_trace_*.json")
    doc = json.loads(path.read_text())

    got = report.summarize(doc)
    assert got == ref_report.summarize(doc)
    assert sorted(got["ranks"]) == list(range(np_))
    assert all(r["events"] > 0 and r["wall_s"] > 0 for r in got["ranks"].values())
    assert {"comm.send", "comm.recv", "compute.spin"} <= set(got["ops"])
    assert report.validate(doc, report.default_schema()) == []
    if transport == "hier":
        assert "coll.two_level" in got["ops"]
        fabrics = {(e.get("args") or {}).get("fabric") for e in doc["traceEvents"]}
        assert {"shm", "tcp"} <= fabrics

    out, ref_out = io.StringIO(), io.StringIO()
    report.print_report(str(path), doc, out=out)
    ref_report.print_report(str(path), doc, out=ref_out)
    assert out.getvalue() == ref_out.getvalue()

    def cli(module):
        return subprocess.run([sys.executable, "-m", module, "--validate", str(path)],
                              capture_output=True, text=True, timeout=60, cwd=REPO,
                              env=dict(os.environ, JAX_PLATFORMS="cpu"))

    port, ref = cli("repro_torch.obs.report"), cli("repro.obs.report")
    assert port.returncode == ref.returncode == 0, port.stderr
    assert port.stdout == ref.stdout and "schema OK" in port.stdout


def test_validate_reports_the_references_violations():
    doc = {"traceEvents": [{"name": "comm.send", "ph": "X", "ts": -1.0, "dur": "slow",
                            "pid": 0, "tid": 0, "args": {"bytes": 8}},
                           {"ph": "Q", "ts": 0.0, "pid": 1}],
           "displayTimeUnit": 3}
    schema = report.default_schema()
    assert schema == ref_report.default_schema()
    errs = report.validate(doc, schema)
    assert errs and errs == ref_report.validate(copy.deepcopy(doc), schema)
    assert report.validate([], schema) == ref_report.validate([], schema) != []
