"""The plain reference and its control.

On the CPU the port runs its kernels' plain versions, so the frozen
reference has to agree with it within the check's limits (it agrees bit
for bit); the control (the reference with TF32 products) has to fail them;
and a run whose timed path is broken underneath has to come out not
correct. On the card (marker ``gpu``) each cell's short check runs at the
cell's own size."""

import pytest
import torch

from perfbench import harness
from perfbench.reference.control import TF32Matmuls
from perfbench.tests.small import small_cell

WORKLOADS = ["bench_30x1M.triangle", "bounded_30x1M.triangle_meanlikes"]


def _program_and_reference(cell, seed=7):
    from perfbench.chains import chain_seed, make_chain

    chain = make_chain(cell.config, chain_seed(seed, 0), "cpu")
    analysis = cell.analysis.Analysis(cell.config, dict(cell.traffic, pool=1), [chain], "cpu", seed)
    analysis.setup()
    got = analysis.served(analysis.run(0))
    analysis.release()
    return analysis, got, analysis.reference(got)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_agrees_with_the_ports_cpu_path_and_the_control_does_not(workload):
    cell = small_cell(workload, samples=10_000, params=5)
    analysis, got, want = _program_and_reference(cell)
    numbers, notes = analysis.compare(got, want)
    assert not notes["route_mismatches"]
    for key, value in numbers.items():
        assert value <= cell.limits[key], (key, value)
    with TF32Matmuls():
        control = analysis.reference(got)
    numbers, _ = analysis.compare(control, want)
    assert any(value > cell.limits[key] for key, value in numbers.items()), numbers


def _answers(groups, shift=0.0):
    one = {"P": torch.ones(2, 4)}
    two = {(0, 1): {"P": torch.eye(4) + shift, "contours": torch.tensor([0.5, 0.1])}}
    return {"one": one, "two": two, "groups": groups}


@pytest.mark.parametrize("groups, mismatched", [
    ([{"fine": 256, "winw": 30, "pairs": [(0, 1)], "bandwidths": "assist"}], False),
    ([{"fine": 256, "winw": 30, "pairs": [(0, 1)], "bandwidths": "assist"},
      {"fine": 256, "winw": 126, "pairs": [(0, 1)], "bandwidths": "clamped"}], False),
    ([], True),
    ([{"fine": 256, "winw": 126, "pairs": [(0, 1)], "bandwidths": "clamped"}], True),
], ids=["assist", "assist_then_clamped", "not_rerun", "clamped_only"])
def test_a_pair_left_to_a_host_rescue_is_judged_by_its_route(groups, mismatched):
    cell = small_cell("bench_30x1M.triangle", samples=1_000, params=2)
    analysis = cell.analysis.Analysis(cell.config, cell.traffic, [None], "cpu", 1)
    want = dict(_answers([], shift=0.5), uncovered={(0, 1): "assist"})
    numbers, notes = analysis.compare(_answers(groups), want)
    assert (numbers["density_gap"] == 1.0) is mismatched
    assert bool(notes["route_mismatches"]) is mismatched


def _stale(monkeypatch):
    """Each call answers with the previous call's result (of the other chain of the pool): a
    step that hands on its state unchanged."""
    from getdist_tpu_torch.mcsamples import MCSamples

    last = []
    original = MCSamples.fastTriangleDensities

    def stale(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        last.append(out)
        return last[-2] if len(last) > 1 else out

    monkeypatch.setattr(MCSamples, "fastTriangleDensities", stale)


def _half_batch(monkeypatch):
    """The pair histograms bin the first half of the samples and double them: half the batch
    left out, the mean taken over the rest."""
    from getdist_tpu_torch.ops import batched

    original = batched.pair_histograms

    def half(ix, weights, *args, **kwargs):
        n = ix.shape[1] // 2
        return original(ix[:, :n].contiguous(), weights[:n].contiguous(), *args, **kwargs) * 2

    monkeypatch.setattr(batched, "pair_histograms", half)


def _altered(monkeypatch):
    """One bin of the first grid of every convolution is moved by 1% of its peak: an answer
    altered where it is produced."""
    from getdist_tpu_torch.ops import batched

    original = batched.dft_conv2d

    def altered(*args, **kwargs):
        out = original(*args, **kwargs)
        out[0, out.shape[1] // 2, out.shape[2] // 3] += 0.01 * out[0].abs().max()
        return out

    monkeypatch.setattr(batched, "dft_conv2d", altered)


@pytest.mark.parametrize("fault", [_stale, _half_batch, _altered], ids=["state_unchanged", "half_batch", "altered"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    cell = small_cell("bench_30x1M.triangle", samples=10_000, params=4, pool=2, checked=2)
    fault(monkeypatch)
    # a window of at least two analyses, so both chains of the pool are answered and checked
    out = harness.run(cell, 11, 1e-3, False, device="cpu")
    assert out["correct"] is False
    assert out["attempted"] >= 2


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_cells_short_check_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = harness.run(harness.Cell(workload), 2**31 + 17, 2.0, False, device="cuda")
    assert out["correct"] is True, out["checks"]
    assert out["device"]["kind"] == torch.cuda.get_device_name(0)
