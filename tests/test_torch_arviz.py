"""The port's ArviZ bridge against the JAX package's.

``getdist_tpu_torch.arviz_wrapper.arviz_to_mcsamples`` and
``getdist_tpu.arviz_wrapper.arviz_to_mcsamples`` convert the same
duck-typed InferenceData stand-ins (``tests/test_arviz_fake.py``'s, neither
arviz nor xarray is installed here) under every option: coordinate-aware
names, ``var_names`` filtering, custom labels and ranges, per-chain
arrays, a single chain, weights and summed log-likelihood variables, a
labeller, a 2-D core shape and a dimension without coordinates. Names,
labels, ranges, samples, weights, loglikes, chain offsets and the
dataset label are equal bit for bit; ``.margestats`` text byte for byte
(the JAX side with x64 off, its numpy statistics); the same exceptions
with the same messages.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

import jax  # noqa: E402
from getdist_tpu.arviz_wrapper import arviz_to_mcsamples as jax_to_mcsamples  # noqa: E402
from getdist_tpu_torch.arviz_wrapper import arviz_to_mcsamples  # noqa: E402
from getdist_tpu_torch.mcsamples import MCSamples  # noqa: E402
from test_arviz_fake import FakeDataArray, FakeGroup, FakeIData, make_idata  # noqa: E402


@contextlib.contextmanager
def jax_numpy_stats():
    with jax.enable_x64(False):
        yield


class FakeLabeller:
    """An arviz BaseLabeller's ``make_label_flat``."""

    def make_label_flat(self, var_name, sel, isel):
        if not sel:
            return rf"L_{{{var_name}}}"
        return rf"L_{{{var_name}}}[" + ",".join(f"{k}={v}" for k, v in sel.items()) + "]"


def _wide_idata():
    """Posterior with a 2-D core shape (one coordinate named, one not) and
    a single chain."""
    rng = np.random.RandomState(5)
    return FakeIData(posterior=FakeGroup({
        "sigma": FakeDataArray(np.abs(rng.standard_normal((1, 300))) + 0.1, ("chain", "draw")),
        "beta": FakeDataArray(rng.standard_normal((1, 300, 2, 3)), ("chain", "draw", "row", "col"),
                              coords={"row": ["x y", "z.w"]}),
    }))


# name -> (idata maker, keyword arguments)
CASES = {
    "default": (make_idata, {}),
    "coords_in_name": (make_idata, {"include_coords_in_name": True}),
    "var_names": (make_idata, {"var_names": ["theta", "missing"]}),
    "labels_and_ranges": (make_idata, {"custom_labels": {"mu": r"\mu", "theta_1": r"\theta_b"},
                                       "custom_ranges": {"mu": (-3, 3), "theta_2": (None, 4)},
                                       "dataset_label": "schools"}),
    "weights_and_loglikes": (lambda: make_idata(with_weights=True, with_loglikes=True),
                             {"weights_var": "w", "loglikes_var": "obs"}),
    "labeller": (make_idata, {"arviz_labeller": FakeLabeller()}),
    "single_chain_2d_core": (_wide_idata, {"include_coords_in_name": True}),
    "single_chain_labeller": (_wide_idata, {"arviz_labeller": FakeLabeller(), "custom_ranges": {"sigma": (0, None)}}),
}


def _same(got, want):
    assert isinstance(got, MCSamples) and got.device == torch.device("cpu")
    assert got.paramNames.list() == want.paramNames.list()
    assert got.paramNames.labels() == want.paramNames.labels()
    assert (got.ranges.names, got.ranges.lower, got.ranges.upper) == (
        want.ranges.names, want.ranges.lower, want.ranges.upper)
    for attr in ("samples", "weights", "loglikes", "chain_offsets"):
        g, w = getattr(got, attr), getattr(want, attr)
        assert (g is None and w is None) or np.array_equal(g, w), attr
    assert got.label == want.label and got.numrows == want.numrows


@pytest.mark.parametrize("case", sorted(CASES))
def test_conversion_matches_jax(case, capsys):
    make, kwargs = CASES[case]
    idata = make()
    got = arviz_to_mcsamples(idata, device="cpu", **kwargs)
    want = jax_to_mcsamples(idata, **kwargs)
    _same(got, want)
    out = capsys.readouterr().out
    if case == "var_names":
        assert out.count("Variable 'missing' not found") == 2


def test_names_and_arrays():
    """What the conversion gives, spelled out on the default stand-in: the
    flattened names, per-chain offsets, summed and negated loglikes."""
    idata = make_idata(with_weights=True, with_loglikes=True)
    mc = arviz_to_mcsamples(idata, weights_var="w", loglikes_var="obs", device="cpu")
    assert mc.paramNames.list() == ["mu", "theta_0", "theta_1", "theta_2"]
    assert list(mc.chain_offsets) == [0, 100, 200]
    assert np.array_equal(mc.weights, idata.sample_stats["w"].values.reshape(-1))
    assert np.array_equal(mc.loglikes, -idata.log_likelihood["obs"].values.sum(axis=2).reshape(-1))
    named = arviz_to_mcsamples(_wide_idata(), include_coords_in_name=True, device="cpu")
    assert named.paramNames.list()[:4] == ["sigma", "beta_row_x_y_col_0", "beta_row_x_y_col_1", "beta_row_x_y_col_2"]
    assert named.paramNames.list()[4] == "beta_row_zpw_col_0"


def test_margestats_match_jax(tmp_path):
    idata = make_idata(with_weights=True, with_loglikes=True)
    kwargs = {"weights_var": "w", "loglikes_var": "obs", "custom_ranges": {"mu": (-3, 3)}}
    got = arviz_to_mcsamples(idata, device="cpu", **kwargs)
    with jax_numpy_stats():
        want = jax_to_mcsamples(idata, **kwargs)
        want.getMargeStats().saveAsText(str(tmp_path / "jax.margestats"))
    got.getMargeStats().saveAsText(str(tmp_path / "port.margestats"))
    assert (tmp_path / "port.margestats").read_bytes() == (tmp_path / "jax.margestats").read_bytes()


def _bad_shape_idata():
    idata = make_idata(with_loglikes=True)
    idata.log_likelihood._arrays["obs"] = FakeDataArray(np.zeros((2, 99)), ("chain", "draw"))
    return idata


def _no_draw_idata():
    group = FakeGroup({"mu": FakeDataArray(np.zeros((2, 5)), ("chain", "draw"))})
    group.sizes = {"chain": 2, "sample": 5}
    return FakeIData(posterior=group)


# name -> (idata maker, keyword arguments, exception)
ERRORS = {
    "no_posterior": (object, {}, ValueError),
    "no_draw_dim": (_no_draw_idata, {}, ValueError),
    "weights_not_found": (make_idata, {"weights_var": "nope"}, ValueError),
    "loglikes_shape": (_bad_shape_idata, {"loglikes_var": "obs"}, ValueError),
    "nothing_selected": (make_idata, {"var_names": ["missing"]}, ValueError),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_match_jax(case):
    make, kwargs, error = ERRORS[case]
    messages = []
    for convert, extra in ((arviz_to_mcsamples, {"device": "cpu"}), (jax_to_mcsamples, {})):
        with pytest.raises(error) as caught:
            convert(make(), **kwargs, **extra)
        messages.append(str(caught.value))
    assert messages[0] == messages[1]


def test_default_device_is_the_card():
    """Without CUDA the default device raises, as every entry point of the
    port does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: tests/test_torch_cuda.py covers the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        arviz_to_mcsamples(make_idata())
