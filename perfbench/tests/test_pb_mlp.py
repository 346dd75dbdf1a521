"""The reader of MedNeXt's block-MLP kernel, ``mlp.device_ms``: E1's device
time a stack on a trace that has E1, None on one without it, and the metric
listed for the MedNeXt cell."""

import pytest

from perfbench import cells

CELL = "infer-mednext-stack600"


class _NamedTrace:
    """A trace of device operations by name: (name, seconds)."""

    def __init__(self, ops):
        self.ops = ops

    def kernel_seconds(self, patterns):
        return sum(t for name, t in self.ops
                   if any(p in name for p in patterns))


def test_mlp_reader_reads_e1_alone():
    """``mlp.device_ms``: E1's kernels' device ms a stack (the MLP and its
    weight packing), None on a trace without them, as the parent's, whose
    MLPs are torch's matrix products, bias adds and GELU."""
    reader = cells.load_metric("mlp.device_ms")
    parent = _NamedTrace([
        ("void at::native::elementwise_kernel<128, 4, ...>", 1.58),
        ("void at::native::vectorized_elementwise_kernel<8, "
         "at::native::GeluCUDAKernelImpl ...>", 0.62),
        ("nvjet_tst_384x96_64x3_2x1_v_bz_coopA_NNT", 0.18),
        ("void tpuseg::(anonymous namespace)::dwconv_kernel<1, 8, 16, 32, "
         "4>(...)", 0.78)])
    run = cells.Run(units=4, window_s=5.0, spans={}, counters={},
                    trace=parent, work={})
    assert reader.read(run) is None
    run.trace = None
    assert reader.read(run) is None
    run.trace = _NamedTrace(parent.ops + [
        ("void tpuseg::(anonymous namespace)::fused_mlp_kernel<32, 32, 96>"
         "(tpuseg::(anonymous namespace)::Mlp)", 0.5),
        ("tpuseg::(anonymous namespace)::fused_mlp_pack_kernel(const float "
         "*, ...)", 0.02)])
    assert reader.read(run) == pytest.approx(1e3 * 0.52 / 4)


def test_mlp_metric_is_listed_for_the_mednext_cell():
    cell = cells.load_cell(CELL)
    names = {m["name"] for m in cell.per_layer}
    assert "mlp.device_ms" in names
    assert cells.load_metric("mlp.device_ms").MOVES == "infer_mvox_s"
