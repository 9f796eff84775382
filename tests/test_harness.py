"""Smoke tests for the measurement harnesses (probe, scaling, bulk)."""

import json

from medane_tchakorom_ufc_thesis_repository_tpu.parallel import make_mesh
from medane_tchakorom_ufc_thesis_repository_tpu.parallel.probe import (
    measure_collective_latency,
    measure_dispatch_latency,
)


class TestProbe:
    def test_collective_latency_shape(self):
        mesh = make_mesh(2, 4)
        rec = measure_collective_latency(mesh, "intra", payload_floats=256,
                                         rounds=10)
        assert rec["per_round_us"] > 0
        assert rec["payload_bytes"] == 1024

    def test_block_axis(self):
        mesh = make_mesh(2, 4)
        rec = measure_collective_latency(mesh, "block", rounds=5)
        assert rec["rounds"] == 5

    def test_dispatch_latency(self):
        rec = measure_dispatch_latency(samples=5)
        assert rec["median_us"] > 0


class TestScaling:
    def test_weak_scaling_records(self):
        from medane_tchakorom_ufc_thesis_repository_tpu.utils.scaling import (
            run_weak_scaling,
        )

        recs = run_weak_scaling(
            rows_per_device=8, n=16, sweeps=2, device_counts=[2, 4],
            inner_maxiter=4,
        )
        assert len(recs) == 2
        assert all("weak_efficiency" in r for r in recs)
        assert recs[0]["weak_efficiency"] == 1.0


class TestBulk:
    def test_run_one_timeout_isolated(self):
        from medane_tchakorom_ufc_thesis_repository_tpu.utils.bulk import run_one

        rec = run_one(
            ["--alg", "SM", "--m", "8", "--n", "8", "--rtol", "1e-3",
             "--maxiter", "200", "--dtype", "float64"],
            timeout_s=300,
            env={"JAX_PLATFORMS": "cpu"},  # keep the test off any accelerator
        )
        assert rec.get("converged") is True
        assert rec["returncode"] == 0


class TestFlamegraph:
    """The -log_view ::ascii_flamegraph / performance_xml2html.xsl
    analog: PhaseTimer stages -> folded-stack text + HTML artifact."""

    ITEMS = [
        ("Loading", 0.5, 1),
        ("I_Solver", 2.0, 10),
        ("I_Solver/Exchange", 0.4, 10),
        ("Convergence", 0.1, 10),
    ]

    def test_folded_format(self):
        from medane_tchakorom_ufc_thesis_repository_tpu.utils.report import (
            folded,
        )

        lines = folded(self.ITEMS).strip().splitlines()
        assert lines[0] == "Loading 500000"
        assert lines[2] == "I_Solver;Exchange 400000"

    def test_html_artifact(self, tmp_path):
        from medane_tchakorom_ufc_thesis_repository_tpu.utils.report import (
            render_flamegraph,
        )

        html_text = render_flamegraph(self.ITEMS, title="t")
        # every stage appears with its time; nested stage lands in a
        # second lane; widths are shares of total
        assert "Loading 0.500s" in html_text
        assert "Exchange 0.400s" in html_text
        assert html_text.count('<div class="lane">') == 2
        assert "title=" in html_text            # hover layer
        assert "<table>" in html_text           # table view
        assert "prefers-color-scheme: dark" in html_text
        out = tmp_path / "flame.html"
        out.write_text(html_text)
        assert out.stat().st_size > 1000

    def test_xml_artifact(self, tmp_path):
        """-log_view ::ascii_xml analog: nested-timer XML + the
        companion XSL validate and carry the stage tree."""
        import xml.etree.ElementTree as ET

        from medane_tchakorom_ufc_thesis_repository_tpu.utils.report import (
            render_xml,
            render_xml_stylesheet,
        )

        xml_text = render_xml(self.ITEMS, title="t")
        root = ET.fromstring(xml_text)
        assert root.tag == "root"
        names = [e.findtext("name") for e in root.iter("event")]
        assert "Loading" in names and "Exchange" in names
        # nesting: Exchange is a child event of I_Solver
        isolver = [e for e in root.iter("event")
                   if e.findtext("name") == "I_Solver"][0]
        kids = [e.findtext("name")
                for e in isolver.findall("events/event")]
        assert kids == ["Exchange"]
        # child stage times accumulate into their parents (same
        # convention as render_flamegraph): 0.5 + (2.0+0.4) + 0.1
        assert abs(float(root.findtext("totaltime")) - 3.0) < 1e-9
        # the stylesheet is well-formed XML too
        ET.fromstring(render_xml_stylesheet())

    def test_cli_flame_flag(self, tmp_path):
        from medane_tchakorom_ufc_thesis_repository_tpu.utils import cli

        out = tmp_path / "fl.html"
        rc = cli.main([
            "--alg", "SM", "--m", "16", "--n", "16", "--json",
            "--maxiter", "200", "--flame", str(out),
        ])
        assert rc == 0
        text = out.read_text()
        assert "I_Solver" in text and "lane" in text
