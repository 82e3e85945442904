"""The port's analysis passes (``repro_torch.analysis``): the retargeted
lint rules fire on minimal bad snippets and stay silent on the corrected
ones, the port's tree is clean; the compile audit's byte cells equal the
reference's ``page_kv_bytes`` and its step-shape counts the reference
engine's jit cache sizes; the kernel audit's checks catch deliberately
broken callables (out-of-bounds writes, unwritten rows, stray writes,
shared memory past a block's most, no launch) and pass sound ones; the
check CLI keeps the reference's exit codes."""

import json

import pytest
import torch

from repro.analysis import compile_audit as jaudit

from repro_torch.analysis import check, compile_audit, kernel_audit, lint
from repro_torch.analysis.findings import Finding, compare_baseline
from repro_torch.kernels import loader

KPATH = "src/repro_torch/kernels/fake.py"     # tensor-assert scope
MPATH = "src/repro_torch/models/fake.py"
SPATH = "src/repro_torch/serve/fake.py"
SCHED = "src/repro_torch/serve/scheduler.py"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rules(findings):
    return sorted(f.rule for f in findings)


# -- lint -------------------------------------------------------------------

class TestLintRules:
    def test_uq105_unmasked_pack_fires(self):
        src = ("def pack(lo, hi):\n"
               "    return lo | (hi << 4)\n")
        assert rules(lint.lint_source(src, MPATH)) == ["UQ105"]
        # no scope: it fires anywhere the port's lint reads
        assert rules(lint.lint_source(src, "tools/fake.py")) == ["UQ105"]

    def test_uq105_silent_with_mask(self):
        src = ("def pack(lo, hi):\n"
               "    return (lo & 0x0F) | ((hi & 0x0F) << 4)\n")
        assert lint.lint_source(src, MPATH) == []

    @pytest.mark.parametrize("line", [
        "import torch\n", "import torch.nn as nn\n",
        "from torch import Tensor\n", "import jax.numpy as jnp\n",
        "from repro.serve import scheduler\n", "import repro\n"])
    def test_uq106_device_import_in_host_module_fires(self, line):
        for path in lint.HOST_ONLY:
            assert rules(lint.lint_source(line, path)) == ["UQ106"]

    def test_uq106_silent_elsewhere_and_on_pure_imports(self):
        assert lint.lint_source("import torch\n", SPATH) == []
        src = ("import numpy as np\n"
               "from repro_torch.serve.prefix_cache import PrefixCache\n"
               "from . import sibling\n")
        assert lint.lint_source(src, SCHED) == []

    def test_uq109_hot_path_assert_fires(self):
        src = ("def _take_page(self):\n"
               "    page = self._free_pages.pop()\n"
               "    assert self._ref[page] == 0, 'allocating a live page'\n"
               "    return page\n")
        fs = lint.lint_source(src, SCHED)
        assert rules(fs) == ["UQ109"]
        assert "check_invariants" in fs[0].message
        assert rules(lint.lint_source(
            src, "src/repro_torch/serve/prefix_cache.py")) == ["UQ109"]

    @pytest.mark.parametrize("test", [
        "torch.all(x >= 0)", "(x >= 0).all()", "x.sum().item() > 0",
        "torch.isfinite(x).any()"])
    def test_uq109_tensor_assert_fires(self, test):
        src = f"import torch\ndef kern(x):\n    assert {test}\n    return x\n"
        for path in (KPATH, MPATH):
            fs = lint.lint_source(src, path)
            assert rules(fs) == ["UQ109"]
            assert "host sync" in fs[0].message

    def test_uq109_silent_on_good_forms(self):
        good_hot = ("def _take_page(self):\n"
                    "    page = self._free_pages.pop()\n"
                    "    if self._ref[page] != 0:\n"
                    "        raise RuntimeError('allocating a live page')\n"
                    "    return page\n")
        assert lint.lint_source(good_hot, SCHED) == []
        # kernels / models: host-value asserts (shape plumbing) are fine
        good_kern = ("import torch\n"
                     "def kern(x, bits):\n"
                     "    assert bits in (4, 8), 'static host check'\n"
                     "    assert x.ndim == 2 and torch.is_tensor(x)\n"
                     "    torch._assert_async((x >= 0).all())\n"
                     "    return x * 2\n")
        assert lint.lint_source(good_kern, KPATH) == []
        # other serve/ files keep their asserts
        bare = "def f(x):\n    assert x.all()\n    return x\n"
        assert lint.lint_source(bare, SPATH) == []

    def test_suppression_comment(self):
        src = ("def pack(lo, hi):\n"
               "    return lo | (hi << 4)  # uniqcheck: ignore[UQ105]\n")
        assert lint.lint_source(src, MPATH) == []
        bare = "import torch  # uniqcheck: ignore\n"
        assert lint.lint_source(bare, SCHED) == []
        other = "import torch  # uniqcheck: ignore[UQ105]\n"
        assert rules(lint.lint_source(other, SCHED)) == ["UQ106"]

    def test_finding_key_is_line_number_stable(self):
        src = "import torch\n"
        k1 = lint.lint_source(src, SCHED)[0].key
        k2 = lint.lint_source("\n\n" + src, SCHED)[0].key
        assert k1 == k2

    def test_walk_covers_the_port_the_smoke_tools_and_examples(self):
        rels = {rel for _, rel in lint.iter_python_files(lint.repo_root())}
        for want in ("chip_smoke.py", "tools/ab_phase6b.py",
                     "examples/quickstart_torch.py",
                     "examples/serve_quantized_lm_torch.py",
                     "examples/train_cnn_uniq_torch.py",
                     "src/repro_torch/serve/scheduler.py",
                     "src/repro_torch/analysis/lint.py"):
            assert want in rels
        assert not any(r.startswith("src/repro/") for r in rels)
        assert "examples/quickstart.py" not in rels

    def test_port_tree_is_lint_clean(self):
        assert lint.run_lint() == []


def test_compare_baseline_new_and_fixed():
    f1 = Finding("UQ105", "a.py", "x", "m")
    f2 = Finding("UQ106", "b.py", "y", "m")
    base = {f1.key: f1.to_dict()}
    new, fixed = compare_baseline([f1, f2], base)
    assert new == [f2] and fixed == []
    new, fixed = compare_baseline([], base)
    assert new == [] and fixed == [f1.key]


# -- compile audit ----------------------------------------------------------

class TestCompileAudit:
    def test_byte_cells_equal_the_reference(self):
        findings, info = compile_audit.check_byte_accounting(device="cpu")
        _, ref = jaudit.check_byte_accounting()
        assert findings == []
        assert info["byte_cells"] == ref["byte_cells"]
        assert len(info["byte_cells"]) == 2 * 3 * 2

    def test_full_width_cells_hold_the_formula(self):
        """The published widths the card also audits, on the meta device
        (shapes only: no memory)."""
        findings, info = compile_audit.check_byte_accounting(
            archs=(), device="meta", full=True)
        assert findings == []
        assert [c["cell"] for c in info["byte_cells"]][:2] == [
            "granite_3_8b:full/kv16/page8", "granite_3_8b:full/kv16/page16"]
        assert len(info["byte_cells"]) == 2 * 3 * 2

    def test_step_shapes_equal_the_reference_jit_caches(self):
        findings, info = compile_audit.check_step_shapes(device="cpu")
        jf, ref = jaudit.check_recompile_budget((16, 8, 4))
        assert findings == [] and jf == []
        got = [(c["kv_bits"], c["decode_signatures"],
                c["prefill_signatures"]) for c in info["step_shapes"]]
        want = [(c["kv_bits"], c["decode_signatures"],
                 c["prefill_signatures"]) for c in ref["recompile"]]
        assert got == want == [(16, 1, 2), (8, 1, 2), (4, 1, 2)]

    def test_step_shape_budget_catches_a_varying_shape(self):
        """A decode fed a growing block table breaks the budget."""
        from repro_torch.models import model
        calls = []
        with compile_audit.record_step_shapes() as seen:
            for n in (2, 3):
                bt = torch.zeros((4, n), dtype=torch.int32)
                try:
                    model.decode(None, None, None, {}, torch.zeros((4, 1)),
                                 torch.zeros(4), block_tables=bt)
                except Exception:   # noqa: BLE001 - only the record counts
                    calls.append(n)
        assert calls == [2, 3] and len(seen["decode"]) == 2
        # the wrapper is gone after the audit
        assert model.decode.__name__ == "decode"


# -- kernel audit -----------------------------------------------------------

def _copy_case(bad=None, int_out=False):
    """A plain "kernel": out = x + 1 into a loader-allocated output, with
    an optional fault."""
    def fn(g):
        x = g.input(torch.arange(32, dtype=torch.float32).reshape(4, 8))
        dtype = torch.int8 if int_out else torch.float32
        out = loader.empty((4, 8), dtype, "cpu")
        want = (x + 1).to(dtype)
        out.copy_(want)
        if bad == "oob":
            torch.as_strided(out, (33,), (1,))[32] = 1
        elif bad == "hole":      # the last row keeps its fill
            out[-1].view(torch.uint8).fill_(
                g.sentinel if int_out else 0xFF)
        elif bad == "wrong":
            out[0, 0] += 5
        elif bad == "read_past":
            out.view(-1)[-1] = torch.as_strided(x, (33,), (1,))[32] + 1
        return [kernel_audit.Check("out", out, want, 0.0)]
    return kernel_audit.KernelCase(fn, None)


def _pool_case(stray: bool):
    """Writes two rows of a guarded, sentinel-filled pool; with ``stray``
    also one byte outside them."""
    def fn(g):
        pool = g.output((4, 8), torch.int8)
        want = pool.clone()
        for p in (pool, want):
            p[1] = 3
            p[2] = 4
        if stray:
            pool[3, 0] = 9
        must = torch.zeros((4, 8), dtype=torch.bool)
        must[1:3] = True
        return [kernel_audit.Check("pool", pool, want, 0.0,
                                   must_write=must)]
    return kernel_audit.KernelCase(fn, None)


class TestKernelAudit:
    def _run(self, case):
        return kernel_audit.audit_callable(case, "fake", device="cpu",
                                           guard_bytes=1024)

    @pytest.mark.parametrize("int_out", [False, True])
    def test_sound_callable_is_clean(self, int_out):
        findings, info = self._run(_copy_case(int_out=int_out))
        assert findings == []
        assert info["runs"] == (2 if int_out else 1)

    @pytest.mark.parametrize("int_out", [False, True])
    def test_write_one_past_the_view_is_oob(self, int_out):
        findings, _ = self._run(_copy_case("oob", int_out))
        assert rules(findings) == ["KERNEL-OOB"] * (2 if int_out else 1)

    @pytest.mark.parametrize("int_out", [False, True])
    def test_unwritten_row_is_a_coverage_hole(self, int_out):
        findings, _ = self._run(_copy_case("hole", int_out))
        assert "KERNEL-COVERAGE" in rules(findings)

    def test_code_equal_to_a_sentinel_is_not_a_hole(self):
        """A written code equal to the first run's sentinel is told apart
        by the second run's."""
        def fn(g):
            out = loader.empty((8,), torch.uint8, "cpu")
            want = torch.full((8,), kernel_audit.SENTINELS[0],
                              dtype=torch.uint8)
            out.copy_(want)
            return [kernel_audit.Check("out", out, want, 0.0)]
        findings, info = self._run(kernel_audit.KernelCase(fn, None))
        assert findings == [] and info["runs"] == 2

    def test_disagreement_with_the_plain_version(self):
        findings, _ = self._run(_copy_case("wrong"))
        assert rules(findings) == ["KERNEL-MISMATCH"]

    @pytest.mark.parametrize("off,flagged", [(1, False), (4, True)])
    def test_bf16_matmul_result_held_relative_to_its_largest(self, off,
                                                             flagged):
        """A bf16 matmul result one bf16 step (2^-8 of the largest) from
        its plain version passes ``TOL_QMM_BF16_REL``; four steps fail."""
        def fn(g):
            want = (torch.arange(32, dtype=torch.float32) / 8 + 1).to(
                torch.bfloat16).reshape(4, 8)
            out = loader.empty((4, 8), torch.bfloat16, "cpu")
            out.copy_(want)
            big = want.float().abs().max()
            out[0, 0] += big * off * 2.0 ** -8
            return [kernel_audit._qmm_check("out", out, want, 0.0)]
        findings, _ = self._run(kernel_audit.KernelCase(fn, None))
        assert rules(findings) == (["KERNEL-MISMATCH"] if flagged else [])

    def test_read_past_an_input_reaches_the_result_as_nan(self):
        """The NaN guard read past the input lands in the result, where
        the audit sees it as an element the kernel left unwritten."""
        findings, _ = self._run(_copy_case("read_past"))
        assert rules(findings) == ["KERNEL-COVERAGE"]

    @pytest.mark.parametrize("stray", [False, True])
    def test_pool_bytes_outside_the_destinations_stay(self, stray):
        findings, _ = self._run(_pool_case(stray))
        assert rules(findings) == (["KERNEL-STRAY"] if stray else [])

    def test_case_that_launches_nothing_is_nocall(self):
        case = kernel_audit.KernelCase(lambda g: [], "qmatmul")
        findings, _ = self._run(case)
        assert rules(findings) == ["KERNEL-NOCALL"]

    def test_case_that_raises_is_an_error_finding(self):
        def fn(g):
            raise RuntimeError("launch failed with code 1")
        findings, info = self._run(kernel_audit.KernelCase(fn, "qmatmul"))
        assert rules(findings) == ["KERNEL-ERROR"]
        assert "code 1" in info["error"]

    def test_attribute_table_over_a_block_is_a_finding(self):
        entry = dict(name="k<1>", static_smem=40_000, dynamic_smem=200_000,
                     regs=128, local_bytes=0, threads=256, blocks_per_sm=1)
        fs = kernel_audit.check_attributes([entry], "fake")
        assert rules(fs) == ["KERNEL-SMEM"]
        ok = dict(entry, dynamic_smem=kernel_audit.SMEM_LIMIT - 40_000)
        assert kernel_audit.check_attributes([ok], "fake") == []
        none_fit = dict(ok, blocks_per_sm=0)
        assert rules(kernel_audit.check_attributes([none_fit], "fake")) == \
            ["KERNEL-OCCUPANCY"]

    def test_kernel_table_summarises_by_wrapper(self):
        e = dict(library="qmatmul", name="qmatmul_wg_kernel<4,16,0>",
                 static_smem=0, dynamic_smem=60_000, regs=90, local_bytes=0,
                 threads=384, blocks_per_sm=3)
        info = {"kernels": [
            {"kernel": "qmatmul[w4]", "counter": "qmatmul",
             "instantiations": [e]},
            {"kernel": "qmatmul[w8]", "counter": "qmatmul",
             "instantiations": [dict(e, name="r", dynamic_smem=0, regs=20,
                                     blocks_per_sm=8)]}]}
        row = kernel_audit.kernel_table(info)["qmatmul"]
        assert row["cases"] == ["qmatmul[w4]", "qmatmul[w8]"]
        assert (row["dynamic_smem"], row["regs"], row["blocks_per_sm"]) == \
            (60_000, 90, 3)

    @pytest.mark.parametrize("name", [
        n for n in kernel_audit.KERNEL_CASES if n.startswith("qmatmul")])
    def test_matmul_cases_hold_f32_and_bf16_results(self, name):
        """Every call of a matmul case is checked at both result dtypes
        the main path writes: f32 within its kernel's tolerance, bf16
        relative to the largest result."""
        g = kernel_audit.Guarded("cpu", guard_bytes=1024)
        checks = kernel_audit.KERNEL_CASES[name].fn(g)
        by = {}
        for c in checks:
            call, dt = c.name.split(":")
            by.setdefault(call, {})[dt] = c
        assert by and all(set(d) == {"f32", "bf16"} for d in by.values())
        for d in by.values():
            assert d["f32"].got.dtype == torch.float32
            assert d["bf16"].got.dtype == torch.bfloat16
            assert d["bf16"].limit == kernel_audit.TOL_QMM_BF16_REL
            assert float(d["bf16"].scale) == pytest.approx(
                float(d["bf16"].want.float().abs().max()))

    def test_cases_cover_the_reference_names_and_the_port_kernels(self):
        from repro.analysis import kernel_audit as jka
        from repro_torch.kernels import ops
        names = set(kernel_audit.KERNEL_CASES)
        assert set(jka.KERNEL_CASES) <= names
        counters = {c.counter for c in kernel_audit.KERNEL_CASES.values()}
        assert counters == set(ops.launch_counts())

    @pytest.mark.parametrize("name", sorted(kernel_audit.KERNEL_CASES))
    def test_case_agrees_with_itself_through_the_plain_versions(self, name):
        """On the CPU every wrapper takes its plain version: the case's
        inputs, destinations and comparisons hold there (the kernels are
        audited on the card)."""
        case = kernel_audit.KERNEL_CASES[name]
        findings, _ = kernel_audit.audit_callable(
            kernel_audit.KernelCase(case.fn, None), name, device="cpu",
            guard_bytes=1024)
        assert findings == []

    def test_run_needs_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="cuda"):
            kernel_audit.run_kernel_audit()
        with pytest.raises(RuntimeError, match="CUDA device"):
            kernel_audit.run_kernel_audit(device="cpu")


# -- the CLI ----------------------------------------------------------------

class TestCheckCLI:
    def test_cpu_passes_are_clean_against_the_baseline(self, capsys):
        rc = check.main(["--only", "lint,compile,mc", "--device", "cpu",
                         "--baseline", "analysis_baseline_torch.json",
                         "--format", "json"])
        out = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert out["findings"] == [] and out["summary"]["ok"]
        assert out["summary"]["passes"] == ["lint", "compile", "mc"]
        assert all(st["exhausted"] for st in out["info"]["mc"])
        assert len(out["info"]["byte_cells"]) == 12

    def test_new_finding_fails_and_baseline_absorbs_it(self, monkeypatch,
                                                       tmp_path, capsys):
        bad = Finding("UQ105", "src/repro_torch/x.py", "y", "m", 3)
        monkeypatch.setattr(lint, "run_lint", lambda: [bad])
        assert check.main(["--only", "lint"]) == 1
        base = str(tmp_path / "b.json")
        assert check.main(["--only", "lint", "--write-baseline", base]) == 1
        assert check.main(["--only", "lint", "--baseline", base]) == 0
        monkeypatch.setattr(lint, "run_lint", lambda: [bad, bad])
        assert check.main(["--only", "lint", "--baseline", base,
                           "--assert-no-growth"]) == 1
        capsys.readouterr()

    def test_unknown_pass_is_exit_2(self, capsys):
        assert check.main(["--only", "lint,nope"]) == 2
        assert "nope" in capsys.readouterr().err

    def test_bench_raises(self):
        with pytest.raises(RuntimeError, match="item 1"):
            check.main(["--only", "bench", "--device", "cpu"])

    def test_kernel_pass_raises_without_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError):
            check.main(["--only", "kernel"])
