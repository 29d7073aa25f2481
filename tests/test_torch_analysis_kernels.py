"""The port's Tier K (``analysis.kernels``), its shared-memory accountants,
the memory audit (``analysis.memory_audit``) and the measured accounting
(``obs.costs``).

- K001-K005 on bad/clean twins (``tests/data/graftcheck_torch``, CUDA
  sources and one Python module), the walkers' path cases, the scan's
  non-vacuity floors;
- the accountants: ``csrc/smem_budget.h`` built with ``g++`` into
  ``build/`` and every Python twin in ``ops/gpu_kernels.py`` equal to it at
  200 or more planner-domain points a kernel; the sweep at the three
  shapes of each of the eight kernels;
- the memory audit: the walker within 2× of raft_tpu's itemized LUT model
  at the same shape, the untiled LUT variant flagged, every default entry
  within the budget;
- the calibration: the merges' counted receive bytes equal
  ``solve_merge_bytes``, every C001 of the CPU's calibration baselined.
"""

import itertools
import os
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from raft_tpu.analysis import jaxpr_audit as jax_audit

import raft_tpu_torch.analysis as P
from raft_tpu_torch.analysis import kernels as K
from raft_tpu_torch.analysis import memory_audit as MA
from raft_tpu_torch.analysis.astutils import ModuleInfo
from raft_tpu_torch.analysis.findings import load_baseline, split_by_baseline
from raft_tpu_torch.core.resources import solve_merge_bytes
from raft_tpu_torch.obs import costs
from raft_tpu_torch.ops import gpu_kernels as gk
from raft_tpu_torch.parallel.comms import init_comms

REPO = str(Path(__file__).resolve().parents[1])
FIX = os.path.join(REPO, "tests", "data", "graftcheck_torch")
TWINS = K.python_accountants(REPO)


def _src(name, text=None, tmp_path=None):
    if text is None:
        return K.CudaSource(os.path.join(FIX, name),
                            f"tests/data/graftcheck_torch/{name}")
    p = tmp_path / name
    p.write_text(text)
    return K.CudaSource(str(p), name)


def _rules(src):
    """Every CUDA rule over one source."""
    return (K.rule_async_pairing(src) + K.rule_smem_accounting(src, TWINS)
            + K.rule_alignment(src) + K.rule_barrier_divergence(src))


# ------------------------------------------------------------ K-rule twins

@pytest.mark.parametrize("rule_id,stem,expect_qual", [
    ("K001", "k001", "leaky_kernel"),
    ("K002", "k002", "launch"),
    ("K003", "k003", "stage_kernel"),
    ("K005", "k005", "skewed_kernel"),
])
def test_cuda_rule_flags_bad_and_passes_clean(rule_id, stem, expect_qual):
    found = _rules(_src(f"{stem}_bad.cu"))
    assert [(f.rule, f.qualname) for f in found] == [(rule_id, expect_qual)]
    assert _rules(_src(f"{stem}_clean.cu")) == []


def test_k004_flags_the_cpu_branch_to_a_plain_version():
    def mod(twin):
        return ModuleInfo(os.path.join(FIX, f"k004_{twin}.py"),
                          f"k004_{twin}.py", "raft_tpu_torch.ops.k004")
    found = K.rule_cpu_divergence(mod("bad"))
    assert [(f.rule, f.qualname) for f in found] == [("K004", "scale")]
    assert K.rule_cpu_divergence(mod("clean")) == []


def test_k004_enumerates_every_wrapper_of_the_port():
    found = [f for f in K.run_kernels(REPO) if f.rule == "K004"]
    assert sorted(f.qualname for f in found) == sorted(
        ["fused_l2_topk", "fused_ivf_topk", "streaming_select_k",
         "fused_pq_topk", "fused_cagra_topk", "fused_l2_argmin", "ivf_scan",
         "ring_shift"])


_HELPERS = """
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(n) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile("{ mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1; }"
               ::"r"(bar), "r"(parity) : "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
"""


@pytest.mark.parametrize("body,n_k001", [
    # a pipeline: the loop commits and waits, the tail drains
    ("for (int i = 0; i < n; ++i) { commit(); wait_groups<1>(); }\n"
     "wait_groups<0>();", 0),
    # a loop that commits every iteration and never waits inside
    ("for (int i = 0; i < n; ++i) { commit(); }\nwait_groups<0>();", 1),
    # a local lambda that commits, called in a waiting loop
    ("auto issue = [&](int s) { commit(); };\n"
     "issue(0);\nfor (int i = 1; i < n; ++i) { issue(i); wait_groups<1>(); }"
     "\nwait_groups<0>();", 0),
    # wgmma groups pair the same way
    ("for (int i = 0; i < n; ++i) { wg_commit(); wg_wait<1>(); }\n"
     "wg_wait<0>();", 0),
    ("wg_commit();", 1),
])
def test_k001_pipeline_paths(tmp_path, body, n_k001):
    src = _src("p.cu", _HELPERS + "__global__ void k(int n) {\n" + body
               + "\n}\n", tmp_path)
    found = K.rule_async_pairing(src)
    assert [f.rule for f in found] == ["K001"] * n_k001, \
        [f.format() for f in found]


@pytest.mark.parametrize("body,needle", [
    # full is armed and waited, empty's waits are in a helper it is handed
    ("mbar_init(smem_u32(full), 1);\nmbar_init(smem_u32(empty), 128);\n"
     "const unsigned bar = smem_u32(full);\nmbar_expect_tx(bar, 64);\n"
     "mbar_wait(smem_u32(full), 0);\nconsume(empty);", None),
    ("mbar_init(smem_u32(full), 1);\nmbar_expect_tx(smem_u32(full), 64);",
     "never waited"),
    ("mbar_init(smem_u32(full), 2);\nmbar_expect_tx(smem_u32(full), 64);\n"
     "mbar_wait(smem_u32(full), 0);", "expects 2 arrival(s)"),
])
def test_k001_mbarrier_pairing(tmp_path, body, needle):
    text = (_HELPERS + "__device__ unsigned smem_u32(const void* p);\n"
            "__device__ void consume(unsigned long long* e) {\n"
            "  mbar_wait(smem_u32(e), 1);\n}\n"
            "__global__ void k() {\n"
            "  __shared__ unsigned long long full[1], empty[1];\n"
            + body + "\n}\n")
    found = K.rule_async_pairing(_src("m.cu", text, tmp_path))
    if needle is None:
        assert found == [], [f.format() for f in found]
    else:
        assert len(found) == 1 and needle in found[0].message


def test_k005_ignores_a_loop_that_shadows_an_index_name(tmp_path):
    text = ("__global__ void k(float* x, int words) {\n"
            "  const int w = threadIdx.x % 4;\n"
            "  x[w] = 0.f;\n"
            "  for (int w = 0; w < words; ++w) { __syncthreads(); }\n"
            "  if (threadIdx.x == 0) x[0] = 1.f;\n"
            "  __syncthreads();\n}\n")
    assert K.rule_barrier_divergence(_src("s.cu", text, tmp_path)) == []


def test_inline_suppression(tmp_path):
    text = open(os.path.join(FIX, "k005_bad.cu")).read().replace(
        "    __syncthreads();", "    __syncthreads();  // graftcheck: K005")
    assert K.rule_barrier_divergence(_src("k.cu", text, tmp_path)) == []


def test_kernel_scan_is_not_vacuous():
    s = K.kernel_stats(REPO)
    assert s["sources"] >= 12 and s["kernels"] >= 15
    assert s["async_sites"] >= 20 and s["launches"] >= 15
    assert s["accounted_smem_sites"] >= 20
    names = {fn.name for src in K.collect_cuda_sources(REPO)
             for fn in src.functions if fn.kind == "global"}
    assert {"tc_topk_kernel", "grouped_topk_kernel", "grouped_pq_kernel",
            "fused_cagra_warp_kernel", "tc_argmin_kernel", "ivf_scan_kernel",
            "ring_shift_kernel", "select_rows_kernel"} <= names


def test_every_accountant_of_the_header_has_its_python_twin():
    header = open(os.path.join(REPO, "raft_tpu_torch", "csrc",
                               "smem_budget.h")).read()
    exported = set(re.findall(r"long long rtt_(\w+_smem_bytes)\(", header))
    assert exported == set(K.ACCOUNTANT_ARITY)
    assert exported <= TWINS


# ----------------------------------------------- the C++ accountants, built

@pytest.fixture(scope="module")
def cxx():
    if shutil.which("g++") is None and "CXX" not in os.environ:
        pytest.skip("no C++ compiler on this host")
    return K.SmemQueries(K.build_smem_budget(REPO))


def _grid(*axes):
    return list(itertools.product(*axes))


_KS = [1, 2, 9, 10, 16, 17, 31, 32, 33, 64, 81, 100, 243, 256, 512, 1024]

#: accountant → its Python twin's arguments at 200 or more planner-domain
#: points (the C++ takes the same ints; l2_argmin's route 1 = "resident")
POINTS = {
    "l2_topk_tc_smem_bytes": _grid(_KS, [2, 3, 4], [1, 2, 3, 4, 5]),
    "l2_topk_fma_smem_bytes": [(k,) for k in range(1, 1025, 5)],
    "ivf_topk_smem_bytes": _grid(range(1, 1025, 13), [1, 2, 4]),
    "ivf_topk_per_query_smem_bytes": _grid([1, 3, 64, 100, 128, 960],
                                           range(1, 1025, 27)),
    "ivf_scan_smem_bytes": [(e,) for e in (1, 2, 4)] * 70,
    "ivf_group_smem_bytes": [(n,) for n in range(1, 40000, 190)],
    "select_k_smem_bytes": [(k,) for k in range(1, 1025, 5)],
    "pq_topk_smem_bytes": _grid([4, 16, 32, 64, 96, 128, 200],
                                [1, 2, 4, 8], _KS),
    "pq_grouped_smem_bytes": _grid([4, 16, 17, 32, 64, 96, 128],
                                   [1, 2, 4], range(1, 17), [0, 1]),
    "cagra_topk_smem_bytes": _grid([10, 32, 64, 128, 256, 512, 1024],
                                   [3, 96, 128, 960], [1, 2, 4],
                                   [16, 32, 64, 100]),
    "cagra_warp_smem_bytes": _grid([10, 32, 64, 100, 128, 256],
                                   [3, 96, 128, 960], [1, 2, 4], [16, 32, 64]),
    "l2_argmin_smem_bytes": _grid([0, 1], range(32, 2080, 32), [2, 3, 4]),
}


@pytest.mark.parametrize("name", sorted(POINTS))
def test_python_accountants_equal_the_cxx_ones(cxx, name):
    points = POINTS[name]
    assert len(points) >= 200
    twin = getattr(gk, name)
    for args in points:
        py_args = args
        if name == "l2_argmin_smem_bytes":
            py_args = ("resident" if args[0] else "scratch", *args[1:])
        if name == "pq_grouped_smem_bytes":
            py_args = (*args[:3], bool(args[3]))
        assert twin(*py_args) == cxx(name, *args), (name, args)


def test_sweep_covers_the_eight_kernels_and_matches_the_cxx(cxx):
    results, findings = K.kernel_smem_audit(cxx)
    assert findings == [], [f.format() for f in findings]
    assert sorted({r.kernel for r in results}) == sorted(gk.SOURCES)
    assert all(len([r for r in results if r.kernel == k]) == 3
               for k in gk.SOURCES)
    for r in results:
        assert r.ok and r.python_bytes <= gk.SMEM_LIMIT
        if r.accountant:
            assert r.cxx_bytes == r.python_bytes
    # the main path's plans (chip_smoke.py: 10,000 queries, 1M × 128)
    main = {r.kernel: r for r in results if r.point == "main"}
    assert main["fused_l2_topk"].route == "tc"
    assert main["fused_ivf_topk"].route == "grouped"
    assert main["fused_cagra_topk"].route == "warp"


def test_sweep_flags_an_accountant_that_drifts_and_a_bad_plan(
        cxx, monkeypatch):
    class Drifted:
        def __call__(self, name, *args):
            return cxx(name, *args) + (8 if name == "select_k_smem_bytes"
                                       else 0)

    _, findings = K.kernel_smem_audit(
        Drifted(), points={"select_k": K.SWEEP_POINTS["select_k"]})
    assert [(f.rule, f.qualname) for f in findings] == [
        ("K002", "select_k.select_k_smem_bytes")]
    # a TF32 tile whose padded width is off the kernel's k-slice
    real = gk.plan_fused_argmin

    def off_slice(m, n, d):
        p = real(m, n, d)
        return type(p)(p.route, p.d_pad + 4, p.stages, p.x_chunk, p.smem,
                       p.scratch_bytes)
    monkeypatch.setattr(gk, "plan_fused_argmin", off_slice)
    _, findings = K.kernel_smem_audit(
        None, points={"fused_l2_argmin": K.SWEEP_POINTS["fused_l2_argmin"]})
    assert {f.rule for f in findings} == {"K003"}


# ------------------------------------------------------------ memory audit

def test_walker_counts_storages_not_views():
    x = torch.ones(1000, 1000)

    def route(x):
        y = x * 2          # 4 MB
        z = y + 1          # 4 MB: peak 8
        del y
        w = z[0]           # a view keeps z's storage
        del z
        return w + 1       # 4 KB more
    assert MA.peak_live_bytes(route, x) == 8_000_000


def test_walker_within_2x_of_itemized_lut_model():
    budget = MA.DEFAULT_BUDGET_BYTES
    peak = MA.lut_entry(budget).run().peak_bytes
    oracle = jax_audit.lut_itemized_peak(budget_bytes=budget)
    assert oracle == MA.lut_itemized_peak(budget_bytes=budget)
    ratio = max(peak, oracle) / min(peak, oracle)
    assert ratio <= 2.0, (peak, oracle, ratio)
    assert peak <= budget


def test_audit_flags_the_untiled_lut_variant():
    budget = MA.DEFAULT_BUDGET_BYTES
    res = MA.lut_entry(budget, unbounded_variant=True).run()
    assert res.peak_bytes > 4 * budget  # the sift-1M crash: ~7x the budget
    assert [f.rule for f in MA.budget_findings([res])] == ["B001"]


@pytest.fixture(scope="module")
def cpu_calibration():
    """The twelve entries measured on fake tensors and the merges over four
    CPU ranks, once (``obs.costs.calibrate``)."""
    return costs.calibrate(comms=init_comms(["cpu"] * 4))


def test_audit_default_entries_fit_the_budget(cpu_calibration):
    measured = cpu_calibration.entries[:len(MA.ENTRY_MAKERS)]
    assert [e.name for e in measured] == [n for n, _ in MA.ENTRY_MAKERS]
    assert len(measured) == 12 and all(e.temp_bytes > 0 for e in measured)
    results = [MA.AuditResult(e.name, e.temp_bytes, MA.DEFAULT_BUDGET_BYTES)
               for e in measured]
    findings = MA.budget_findings(results)
    assert findings == [], [f.format() for f in findings]


# ------------------------------------------------------------- calibration

def test_merge_bytes_equal_solve_merge_bytes():
    comms = init_comms(["cpu"] * 4)
    entries = costs.merge_entries(comms, nq=64, kk=10, k=10)
    assert [e.name for e in entries] == [
        f"sharded_merge_{m}@s4" for m in ("allgather", "tree", "ring")]
    want = solve_merge_bytes(4, 64, 10, 10)
    for e, mode in zip(entries, ("allgather", "tree", "ring")):
        assert e.collective_bytes == want[mode] == \
            e.predicted_collective_bytes
    report = costs.CostReport("cpu", "cpu", None, entries)
    assert report.calibration_findings() == []
    # three ranks: no tree, and the counts still hold
    entries = costs.merge_entries(init_comms(["cpu"] * 3), nq=8, kk=5, k=7)
    assert [e.name[14:] for e in entries] == ["allgather@s3", "ring@s3"]
    assert all(e.collective_drift_ratio == 1.0 for e in entries)


def test_calibration_drift_is_c001_and_the_cpu_calibration_is_baselined(
        cpu_calibration):
    e = costs.EntryCost("x", "f", None, None, temp_bytes=100,
                        planner="p", predicted_bytes=200)
    found = costs.CostReport("cpu", "cpu", None, [e]).calibration_findings()
    assert [(f.rule, f.qualname) for f in found] == [("C001", "x")]
    report = cpu_calibration
    new, _ = split_by_baseline(report.calibration_findings(),
                               load_baseline(P.BASELINE_PATH))
    assert new == [], [f.format() for f in new]
    lut = [x for x in report.entries if x.name.startswith("ivf_pq.search[l")]
    assert 1 / 1.5 <= lut[0].drift_ratio <= 1.5


def test_measure_entry_on_real_cpu_tensors():
    """A small real IVF-Flat index through the entry the card measures."""
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import ivf_flat

    rng = np.random.default_rng(0)
    data = rng.standard_normal((2000, 16)).astype(np.float32)
    res = Resources(seed=0, device="cpu")
    flat = ivf_flat.build(data, ivf_flat.IndexParams(n_lists=16), res=res)
    ctx = {"queries": torch.from_numpy(data[:64]), "flat": flat,
           "n_probes": 4, "k": 10}
    make = dict(MA.ENTRY_MAKERS)["ivf_flat.search@1m"]
    e = costs.measure_entry("ivf_flat.search@small", make, ctx)
    assert e.device == "cpu" and e.temp_bytes > 0
    assert e.planner == "ivf_flat.plan_scan_tiles"
    assert e.drift_ratio is not None


def test_ptxas_figures_parse_a_report(tmp_path):
    log = tmp_path / "lib.log"
    log.write_text(
        "ptxas info    : Compiling entry function '_Z14tc_topk_kernelILi1EEv"
        "Pf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z14tc_topk_kernelILi1EEvPf\n"
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 168 registers, 1024 bytes smem, 400 bytes "
        "cmem[0]\n")
    figs = costs.ptxas_figures(tmp_path / "lib.so")
    assert figs == {"tc_topk_kernel": {
        "spill_stores": 4, "spill_loads": 4, "registers": 168,
        "static_smem": 1024}}
