"""getdist_tpu_torch.types against getdist_tpu.types on the same inputs.

The port's result types and latex tables are its own copy of the JAX
package's: the significant-figure engine and the number formatter, the
three table formatters, ``ResultTable.tableTex()`` (table and full
document), the ``.margestats`` / ``.likestats`` writers and parsers, and
the ``.converge`` parser. Each output is held to the character against the
JAX package's on the same values, and each file round-trips: written,
parsed and written again, it is the same text. Small pure-Python inputs;
no MCSamples (``tests/test_torch_host_api.py`` holds the text an
MCSamples writes).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

from getdist_tpu import types as jtypes  # noqa: E402
from getdist_tpu.paramnames import ParamInfo as JaxParamInfo  # noqa: E402
from getdist_tpu_torch import types as ttypes  # noqa: E402
from getdist_tpu_torch.paramnames import ParamInfo  # noqa: E402

BOTH = {"port": (ttypes, ParamInfo), "jax": (jtypes, JaxParamInfo)}

# (name, label, derived, mean, err, [(lower, upper, tag) per contour])
PARAMS = [
    ("omegabh2", r"\Omega_b h^2", False, 0.022383, 0.000149, [(0.022234, 0.022532, "two"), (0.02209, 0.02268, "two")]),
    ("tau", r"\tau", False, 0.0543, 0.0073, [(0.0470, 0.0617, "two"), (0.0401, 0.0697, ">")]),
    ("r", "r", False, 0.021, 0.018, [(0.0, 0.027, "<"), (0.0, 0.061, "<")]),
    ("theta", r"\theta", False, 3.14, 1.8, [(0.0, 6.283185307179586, "none"), (0.0, 6.283185307179586, "none")]),
    ("H0", "H_0", True, 67.36, 0.54, [(66.82, 67.91, "two"), (66.28, 68.44, "two")]),
    ("As", r"A_{\rm s}", True, 2.1e-9, 3.0e-11, [(2.07e-9, 2.13e-9, "two"), (2.04e-9, 2.16e-9, "two")]),
    ("chi2_lens", r"\chi^2_{\rm lens}", True, 8.9, 4.2, [(4.7, 13.1, "two"), (0.9, 17.3, "two")]),
    ("skew", "s", True, -1.25, 0.31, [(-1.5, -0.9, "two"), (-1.95, -0.71, "two")]),
]


def _marge(which):
    types, info_cls = BOTH[which]
    m = types.MargeStats()
    m.hasBestFit = False
    m.limits = np.array([0.68, 0.95])
    for name, label, derived, mean, err, lims in PARAMS:
        info = info_cls(name=name, label=label, derived=derived)
        info.mean, info.err = mean, err
        info.limits = [types.ParamLimit([lo, hi], tag) for lo, hi, tag in lims]
        m.names.append(info)
    return m


def _like(which):
    types, info_cls = BOTH[which]
    rng = np.random.default_rng(3)
    stats = types.LikeStats()
    stats.logLike_sample, stats.logMeanInvLike, stats.meanLogLike = 1375.42, 1390.1, 1388.7
    stats.logMeanLike, stats.complexity, stats.varLogLike = 1386.2, 26.56, 13.4
    for name, label, derived, mean, err, _ in PARAMS:
        info = info_cls(name=name, label=label, derived=derived)
        spread = np.sort(rng.standard_normal(4)) * err
        info.ND_limit_bot = mean + spread[:2][::-1] * 2
        info.ND_limit_top = mean + spread[2:] * 2 + 3 * err
        info.bestfit_sample = mean + 0.1 * err
        stats.names.append(info)
    return stats


VALUES = [0.0, 1.0, -1.0, 0.5, 0.05, 12345.678, 0.000123456, -98765.4321, 2.1e-9, 6.02e23, 99.95, 0.099999,
          1.2345e-5, 3.14159265358979, -0.0071, 20.0, 999.5]


@pytest.mark.parametrize("sig", [1, 2, 3, 4, 6])
def test_number_figures_match_jax(sig):
    """numberFigs (plain and scientific) and the formatter's value/limit
    triples on a grid of magnitudes and signs."""
    for value in VALUES:
        assert ttypes.numberFigs(value, sig) == jtypes.numberFigs(value, sig), value
        assert ttypes.numberFigs(value, sig, sci=True) == jtypes.numberFigs(value, sig, sci=True), value
    port_nf, jax_nf = ttypes.NumberFormatter(sig_figs=sig), jtypes.NumberFormatter(sig_figs=sig)
    for value in VALUES:
        for err in (abs(value) * 0.013 + 1e-12, abs(value) * 0.3 + 0.002, 7.5):
            for sci in (False, True):
                assert port_nf.namesigFigs(value, err, -0.8 * err, sci=sci) == jax_nf.namesigFigs(
                    value, err, -0.8 * err, sci=sci), (value, err, sci)
            assert port_nf.formatNumber(value, wantSign=True) == jax_nf.formatNumber(value, wantSign=True)


@pytest.mark.parametrize("formatter", ["TableFormatter", "OpenTableFormatter", "NoLineTableFormatter"])
@pytest.mark.parametrize("ncol,limit", [(1, 1), (1, 2), (2, 2), (3, 1)])
def test_result_table_tex_matches_jax(formatter, ncol, limit):
    """ResultTable.tableTex(), table and full document, every formatter,
    with titles, block ends, a reference result's sigma shifts and a
    parameter subset."""
    tex = {}
    for which, (types, _) in BOTH.items():
        marge = _marge(which)
        ref = _marge(which)
        for info in ref.names:
            info.mean += 0.3 * info.err
        table = types.ResultTable(ncol, [marge], limit=limit, titles=["Planck"], formatter=getattr(types, formatter)(),
                                  blockEndParams=["tau"], refResults=ref, shiftSigma_indep=True)
        subset = types.ResultTable(ncol, [marge, _marge(which)], limit=limit, paramList=["tau", "r", "H0", "As"])
        tex[which] = (table.tableTex(), table.tableTex(document=True, latex_preamble=r"\usepackage{xcolor}"),
                      subset.tableTex())
    assert tex["port"] == tex["jax"]


def test_margestats_text_and_round_trip_match_jax(tmp_path):
    """The .margestats text byte for byte; parsed back by each package, the
    same text again."""
    port_file, jax_file = tmp_path / "port.margestats", tmp_path / "jax.margestats"
    _marge("port").saveAsText(str(port_file))
    _marge("jax").saveAsText(str(jax_file))
    assert port_file.read_bytes() == jax_file.read_bytes()
    loaded = ttypes.MargeStats(str(port_file))
    assert str(loaded) == port_file.read_text()
    assert str(loaded) == str(jtypes.MargeStats(str(jax_file)))
    assert [p.limits[1].limitTag() for p in loaded.names] == [lims[1][2] for *_, lims in PARAMS]
    assert [p.isDerived for p in loaded.names] == [p[2] for p in PARAMS]


def test_likestats_text_and_round_trip_match_jax(tmp_path):
    """The .likestats text byte for byte; the summary block parses back to
    the same values in both packages."""
    port_file, jax_file = tmp_path / "port.likestats", tmp_path / "jax.likestats"
    _like("port").saveAsText(str(port_file))
    _like("jax").saveAsText(str(jax_file))
    assert port_file.read_bytes() == jax_file.read_bytes()
    got, want = ttypes.LikeStats(str(port_file)), jtypes.LikeStats(str(jax_file))
    for key in ("logLike_sample", "logMeanInvLike", "meanLogLike", "logMeanLike", "varLogLike"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.likeSummary() == want.likeSummary() == _like("port").likeSummary()


CONVERGE = """Parameter autocorrelation lengths (effective number of samples N_eff = tot weight/weight length)

                  Weight Length   Sample length           N_eff
omegabh2                  12.31            3.52           19496
tau                       15.02            4.29           15980

var(mean)/mean(var) for eigenvalues of covariance of y of orthonormalized parameters
  1      0.00112
  2      0.00459
  3      0.01321

Parameter auto-correlations as function of step separation

                    15      30      45      60
omegabh2         0.412   0.171   0.071   0.029 \\Omega_b h^2
tau              0.501   0.252   0.126   0.063 \\tau

"""


def test_converge_stats_parse_matches_jax(tmp_path):
    """ConvergeStats reads the R-1 eigenvalues and the autocorrelation table
    of a .converge file as the JAX package does."""
    fname = tmp_path / "chain.converge"
    fname.write_text(CONVERGE)
    got, want = ttypes.ConvergeStats(str(fname)), jtypes.ConvergeStats(str(fname))
    assert got.R_eigs == want.R_eigs == ["0.00112", "0.00459", "0.01321"]
    assert got.worstR() == want.worstR() == "0.01321"
    assert got.auto_correlation_steps == want.auto_correlation_steps == [15, 30, 45, 60]
    assert got.auto_correlation_pars == want.auto_correlation_pars
    assert got.auto_correlations == want.auto_correlations


@pytest.mark.parametrize("limit", [1, 2])
def test_tex_values_of_every_limit_kind_match_jax(limit):
    """texValues for two-tail (merged and separate limits), one-tail, no
    constraint, chi2 and scientific-notation parameters, with a best fit."""
    for name, *_ in PARAMS:
        outs = []
        for which, (types, _) in BOTH.items():
            marge = _marge(which)
            marge.hasBestFit = True
            for info in marge.names:
                info.best_fit = info.mean + 0.05 * info.err
            outs.append(marge.texValues(types.NoLineTableFormatter(), name, limit=limit))
        assert outs[0] == outs[1], name
