"""Result types and LaTeX table generation (host-side).

The port's own copy of ``getdist_tpu/types.py``, behavior-compatible with
the reference ``getdist/types.py``: the Decimal-exact significant-figure
engine, ±limit merging (``x^{+a}_{-b}`` vs ``x \\pm a``), chi-squared
special cases, one-tail ``<``/``>`` forms, σ-shift annotations, three table
formatters, the multi-column ResultTable with latex→PNG rendering, and the
parsers/writers for ``.minimum``/``.bestfit``, ``.margestats``,
``.likestats`` and ``.converge`` files. Its text output is held to the
character against the JAX package's (``tests/test_torch_types.py``).

Layout of this module: file-format parsers first (BestFit, ParamLimit,
MargeStats, LikeStats, ConvergeStats), then the significant-figure engine,
then the latex table machinery.
"""

import decimal
import os
import tempfile
from dataclasses import dataclass
from io import BytesIO
from pathlib import Path
from types import MappingProxyType

import numpy as np

from getdist_tpu_torch.paramnames import ParamInfo, ParamList, makeList

empty_dict = MappingProxyType({})

# |exponent| above which scientific notation kicks in
_sci_tolerance = 4


class TextFile:
    def __init__(self, lines=None):
        self.lines = [lines] if isinstance(lines, str) else list(lines or [])

    def write(self, outfile):
        Path(outfile).write_text("\n".join(self.lines), encoding="utf-8")


def texEscapeText(string):
    return r"{\textunderscore}".join(string.split("_"))


def times_ten_power(exponent):
    return r"\cdot 10^{%d}" % int(exponent)


class ParamResults(ParamList):
    """Base for sets of per-parameter results (self.names holds ParamInfo
    objects carrying result attributes)."""


# ---------------------------------------------------------------------------
# file-format parsers / writers
# ---------------------------------------------------------------------------


@dataclass
class LikelihoodChi2:
    name: str = ""
    tag: str | None = None
    chisq: float = 0.0


class BestFit(ParamResults):
    """Result of a likelihood minimization, parsed from CosmoMC/Cobaya
    .minimum or .bestfit text (incl. per-likelihood chi2 blocks)."""

    def __init__(self, fileName=None, setParamNameFile=None, want_fixed=False, max_posterior=True):
        """
        :param fileName: .minimum-format text file
        :param setParamNameFile: .paramnames file overriding labels
        :param want_fixed: include non-varying parameters
        :param max_posterior: True for .minimum, False for .bestfit
        """
        super().__init__()
        self.max_posterior = bool(max_posterior)
        if fileName:
            self.loadFromFile(fileName, want_fixed)
        if setParamNameFile:
            self.setLabelsFromParamNames(setParamNameFile)

    def getColumnLabels(self, **_kwargs):
        return ["Best fit"]

    @staticmethod
    def _header_keyval(line):
        key, _, val = line.partition("=")
        return key.strip(), val.strip()

    def _parse_chisq_block(self, tail_lines):
        """The trailing per-likelihood chi-squared block of a .minimum file."""
        for raw in tail_lines:
            if not raw.strip():
                continue
            _idx, chisq, remainder = (tok.strip() for tok in raw.split(None, 2))
            kind, colon, label = (tok.strip() for tok in remainder.partition(":"))
            if not colon:
                kind, label = "", kind
            tag, eq, name = (tok.strip() for tok in label.partition("="))
            if not eq:
                tag, name = None, label
            self.chiSquareds.append((kind, LikelihoodChi2(name=name, tag=tag, chisq=float(chisq))))

    def loadFromFile(self, filename, want_fixed=False):
        rows = self.fileList(filename)
        key, val = self._header_keyval(rows[0])
        if key == "weight":
            self.weight = float(val)
            del rows[0]
            key, val = self._header_keyval(rows[0])
        if key != "-log(Like)":
            raise Exception("Error in format of parameter (best fit) file")
        self.logLike = float(val)
        self.chiSquareds = []
        if rows[1].strip():
            del rows[1]  # optional chi-sq header line variant
        in_fixed, in_derived, gaps = False, False, 0
        for idx in range(2, len(rows)):
            raw = rows[idx]
            if not raw.strip():
                gaps += 1
                in_fixed, in_derived = not in_fixed, True
                if gaps == 3:
                    if idx + 2 < len(rows):
                        self._parse_chisq_block(rows[idx + 2 :])
                    break
                continue
            if in_fixed and not want_fixed:
                continue
            num, fit, pname, plabel = (tok.strip() for tok in raw.split(None, 3))
            info = ParamInfo()
            info.isFixed, info.isDerived = in_fixed, in_derived
            info.number, info.best_fit = int(num), float(fit)
            info.name, info.label = pname, plabel
            self.names.append(info)

    def sortedChiSquareds(self):
        by_kind = {}
        for kind, item in self.chiSquareds:
            by_kind.setdefault(kind, []).append(item)
        return sorted(by_kind.items())

    def chiSquareForKindName(self, kind, name):
        hits = (item.chisq for k, item in self.chiSquareds if k == kind and item.name == name)
        return next(hits, None)

    def texValues(self, formatter, p, **_kwargs):
        match = self.parWithName(p.name)
        return None if match is None else [formatter.numberFormatter.formatNumber(match.best_fit)]

    def getParamDict(self, include_derived=True):
        wanted = (info for info in self.names if include_derived or not info.isDerived)
        out = {info.name: info.best_fit for info in wanted}
        out.update(weight=1, loglike=self.logLike)
        return out


class ParamLimit:
    """One marginalized limit: lower/upper bounds plus the tail type.

    :ivar lower: lower limit
    :ivar upper: upper limit
    :ivar twotail: True for a two-tail limit
    :ivar onetail_upper: True for a one-tail upper limit
    :ivar onetail_lower: True for a one-tail lower limit
    """

    _TAGS = ("two", ">", "<", "none")
    _KINDS = ("two tail", "one tail upper limit", "one tail lower limit", "none")

    def __init__(self, minmax, tag="two"):
        """
        :param minmax: [min, max] values (None if unbounded)
        :param tag: 'two' | '>' | '<' | 'none'
        """
        self.lower, self.upper = minmax[0], minmax[1]
        self.twotail, self.onetail_upper, self.onetail_lower = (tag == t for t in self._TAGS[:3])

    def _kind_index(self):
        flags = (self.twotail, self.onetail_upper, self.onetail_lower, True)
        return flags.index(True)

    def limitTag(self):
        """Short tag: 'two', '>', '<' or 'none'."""
        return self._TAGS[self._kind_index()]

    def limitType(self):
        """Human-readable limit type description."""
        return self._KINDS[self._kind_index()]

    def __str__(self):
        return " ".join(["%g" % self.lower, "%g" % self.upper, self.limitTag()])


class MargeStats(ParamResults):
    """Marginalized 1D statistics per parameter (mean, err, limits list);
    round-trips the .margestats text format."""

    def loadFromFile(self, filename):
        """Parse a .margestats file."""
        rows = self.fileList(filename)
        self.limits = [float(tok) for tok in rows[0].split(":")[1].split(";")]
        self.hasBestFit = False
        k = len(self.limits)
        for raw in rows[3:]:
            if not raw.strip():
                break
            cells = [tok.strip() for tok in raw.split(None, 3 * k + 3)]
            info = ParamInfo()
            info.isDerived = cells[0].endswith("*")
            info.name = cells[0][:-1] if info.isDerived else cells[0]
            info.mean, info.err = float(cells[1]), float(cells[2])
            info.label = cells[-1]
            triples = (cells[3 + 3 * i : 6 + 3 * i] for i in range(k))
            info.limits = [ParamLimit([float(lo), float(hi)], kind) for lo, hi, kind in triples]
            self.names.append(info)

    def headerLine(self, inc_limits=False):
        parForm = self.parFormat()
        head = parForm % "parameter" + "  " + "mean".ljust(15) + "sddev".ljust(15)
        for j, frac in enumerate(self.limits):
            tag = "_%.0f%%" % (100 * frac) if inc_limits else str(j + 1)
            head += ("lower" + tag).ljust(15) + ("upper" + tag).ljust(15)
            head += ("type" if inc_limits else "limit" + tag).ljust(7)
        return head, parForm

    def __str__(self):
        head, parForm = self.headerLine()
        levels = "; ".join(str(level) for level in self.limits)
        out = [f"Marginalized limits: {levels}\n\n", head, "\n"]
        for idx, info in enumerate(self.names):
            row = parForm % self.name(idx, True) + "%15.7E%15.7E" % (info.mean, info.err)
            for lim in info.limits:
                row += "%15.7E%15.7E  %-5s" % (lim.lower, lim.upper, lim.limitTag())
            out.append(row + f"   {info.label}\n")
        return "".join(out)

    def saveAsText(self, filename):
        """Write the .margestats text format."""
        Path(filename).write_text(str(self), encoding="utf-8")

    def addBestFit(self, bf):
        self.hasBestFit = True
        self.logLike = bf.logLike
        kept = []
        for info in self.names:
            match = bf.parWithName(info.name)
            if match is None:
                continue  # parameters absent from the best fit are dropped
            info.best_fit, info.isDerived = match.best_fit, match.isDerived
            kept.append(info)
        self.names = kept

    def limitText(self, limit):
        pct = str(round(100.0 * self.limits[limit - 1]))
        return pct[:-2] if pct.endswith(".0") else pct

    def getColumnLabels(self, limit=2):
        cols = ["Best fit"] if self.hasBestFit else []
        cols.append(self.limitText(limit) + "\\% limits")
        return cols

    def _shift_annotation(self, param, refResults, shiftSigma_indep, shiftSigma_subset):
        """σ-shift annotation vs a reference result set, or ''."""
        other = refResults.parWithName(param.name)
        if other is None:
            return ""
        shift = param.mean - other.mean
        if not (shiftSigma_indep or shiftSigma_subset):
            return r"\quad(%+.1f \sigma)" % (shift / other.err)
        note = r"\quad("
        if shiftSigma_subset:
            sigma_sub = max(np.sqrt(abs(param.err**2 - other.err**2)), other.err / 20)
            note += "%+.1f \\sigma_s" % (shift / sigma_sub)
        if shiftSigma_indep:
            sigma_ind = np.sqrt(param.err**2 + other.err**2)
            # the ", " prefix is unconditional in the reference (types.py:883)
            note += ", %+.1f \\sigma_i" % (shift / sigma_ind)
        return note + ")"

    def texValues(self, formatter, p, limit=2, refResults=None, shiftSigma_indep=False, shiftSigma_subset=False):
        """Tex snippet(s) for one parameter's constraint (reference
        ``types.py:824-897``): ±limit merging, chi2 special case, one-tail
        forms, sci-notation wrapping, σ-shift annotations, best fit."""
        param = self.parWithName(p if not isinstance(p, ParamInfo) else p.name)
        if param is None:
            return None
        nf = formatter.numberFormatter
        lim = param.limits[limit - 1]
        if param.name.startswith("chi2"):
            res = self._chi2_tex(nf, param, limit)
        elif lim.twotail:
            res = self._twotail_tex(nf, param, lim, limit)
        elif lim.onetail_upper or lim.onetail_lower:
            bound, mark = (lim.upper, "< ") if lim.onetail_upper else (lim.lower, "> ")
            body, power = nf.formatNumber(bound, 3, sci=True)
            res = mark + body + (times_ten_power(power) if power else "")
        else:
            res = formatter.noConstraint
        if refResults is not None and res != formatter.noConstraint:
            res += self._shift_annotation(param, refResults, shiftSigma_indep, shiftSigma_subset)
        if not self.hasBestFit:
            return [res]
        halfwidth = (lim.upper - lim.lower) / 10
        bestfit, _, _, power = nf.namesigFigs(param.best_fit, halfwidth, -halfwidth, sci=True)
        return [res, bestfit + times_ten_power(power) if power else bestfit]

    @staticmethod
    def _chi2_tex(nf, param, limit):
        # chi2 is very skewed for low dof: always mean ± sigma or dof
        res, sigma, _ = nf.namesigFigs(param.mean, param.err, param.err, wantSign=False, sci=False)
        if limit == 1:
            return res + r"\pm " + sigma
        return res + r"\,({\nu\rm{:}\,%.1f})" % (0.5 * param.err**2)

    @staticmethod
    def _twotail_tex(nf, param, lim, limit):
        up_off, down_off = lim.upper - param.mean, lim.lower - param.mean
        if nf.plusMinusLimit(limit, up_off, down_off):
            res, hi, lo, power = nf.namesigFigs(param.mean, up_off, down_off, sci=True)
            res += "^{%s}_{%s}" % (hi, lo)
        else:
            res, hi, _, power = nf.namesigFigs(param.mean, param.err, param.err, wantSign=False, sci=True)
            res += r"\pm " + hi
        return r"\left(\,%s\,\right)" % res + times_ten_power(power) if power else res


class LikeStats(ParamResults):
    """Posterior statistics: best-fit sample, likelihood moments, and
    per-parameter extrema of the N-D confidence regions."""

    def loadFromFile(self, filename):
        """Parse the summary block of a .likestats file."""
        summary = {}
        for raw in self.fileList(filename):
            if not raw.strip():
                break
            key, _, val = raw.partition("=")
            summary[key.strip()] = float(val)
        self.logLike_sample = summary.get("Best fit sample -log(Like)")
        self.logMeanInvLike = summary.get("Ln(mean 1/like)")
        self.meanLogLike = summary.get("mean(-Ln(like))")
        self.logMeanLike = summary.get("-Ln(mean like)")
        self.complexity = summary.get("complexity")
        doubled = summary.get("2*Var(Ln(like))")
        self.varLogLike = None if doubled is None else 0.5 * doubled

    def likeSummary(self):
        out = [f"Best fit sample -log(Like) = {self.logLike_sample:f}"]
        if self.logMeanInvLike:
            out.append(f"Ln(mean 1/like) = {self.logMeanInvLike:f}")
        out.append(f"mean(-Ln(like)) = {self.meanLogLike:f}")
        out.append(f"-Ln(mean like)  = {self.logMeanLike:f}")
        out.append(f"2*Var(Ln(like)) = {2.0 * self.varLogLike:f}")
        return "\n".join(out) + "\n"

    def headerLine(self):
        cols = "".join(tag.ljust(15) for tag in ("bestfit", "lower1", "upper1", "lower2"))
        return self.parFormat() % "parameter" + "  " + cols + "upper2\n"

    def __str__(self):
        out = self.likeSummary()
        parForm = self.parFormat()
        if self.names:
            out += "\n" + self.headerLine()
            for idx, info in enumerate(self.names):
                if info.ND_limit_bot.size < 2:
                    raise Exception("Likestats output assumes at least two contour levels")
                fields = (
                    info.bestfit_sample,
                    info.ND_limit_bot[0],
                    info.ND_limit_top[0],
                    info.ND_limit_bot[1],
                    info.ND_limit_top[1],
                )
                out += parForm % self.name(idx, True)
                out += "".join("%15.7E" % v for v in fields) + f"   {info.label}\n"
        return out

    def saveAsText(self, filename):
        """Write the .likestats text format."""
        Path(filename).write_text(str(self), encoding="utf-8")


class ConvergeStats(ParamResults):
    """Parser for .converge files (R-1 eigenvalues, autocorrelation table)."""

    def loadFromFile(self, filename):
        try:
            rows = self.fileList(filename)
            self.R_eigs = []
            for i, row in enumerate(rows):
                if "var(mean)" in row:
                    for raw in rows[i + 1 :]:
                        if not raw.strip():
                            break
                        toks = raw.split()
                        self.R_eigs.append(toks[1] if len(toks) > 1 else "1e30")
                elif "Parameter auto-correlations" in row:
                    steps = [int(tok) for tok in rows[i + 2].split()]
                    self.auto_correlation_steps = steps
                    self.auto_correlations, self.auto_correlation_pars = [], []
                    for raw in rows[i + 3 :]:
                        if not raw.strip():
                            break
                        cells = raw.split(None, len(steps) + 1)
                        self.auto_correlation_pars.append(cells[0])
                        self.auto_correlations.append([float(tok) for tok in cells[1:-1]])
        except Exception:
            print(f"Error reading: {filename}")
            raise

    def worstR(self, default=None):
        return self.R_eigs[-1] if self.R_eigs else default


# ---------------------------------------------------------------------------
# significant-figure engine (exact Decimal arithmetic)
# ---------------------------------------------------------------------------


def float_to_decimal(f):
    """Exact float -> Decimal conversion (no precision loss)."""
    num, den = f.as_integer_ratio()
    ctx = decimal.Context(prec=60)
    while True:
        quotient = ctx.divide(decimal.Decimal(num), decimal.Decimal(den))
        if not ctx.flags[decimal.Inexact]:
            return quotient
        ctx.flags[decimal.Inexact] = False
        ctx.prec *= 2


def numberFigs(number, sigfig, sci=False):
    """Format a number to ``sigfig`` significant figures using exact
    Decimal arithmetic; with ``sci`` returns (mantissa_str, exponent)
    switching to scientific form beyond 10^±4 (reference
    ``types.py:50-92``)."""
    assert sigfig > 0
    try:
        d = decimal.Decimal(number)
    except TypeError:
        d = float_to_decimal(float(number))
    power = 0
    if sci:
        power = d.adjusted()
        if abs(power) <= _sci_tolerance:
            power = 0
        else:
            d = decimal.getcontext().multiply(d, float_to_decimal(10.0**-power))
    negative, digs = d.as_tuple()[:2]
    digs = list(digs) + [0] * max(0, sigfig - len(digs))
    kept = int("".join(str(t) for t in digs[:sigfig]))
    if len(digs) > sigfig and digs[sigfig] >= 5:
        kept += 1
    out = list(str(kept))
    # rounding up can grow the digit count; fold that into the place shift
    place = d.adjusted() + len(out) - sigfig
    out = out[:sigfig]
    if place >= sigfig - 1:
        out += ["0"] * (place - sigfig + 1)
    elif place >= 0:
        out.insert(place + 1, ".")
    else:
        out = ["0."] + ["0"] * (-place - 1) + out
    text = ("-" if negative else "") + "".join(out)
    return (text, power) if sci else text


class NumberFormatter:
    """Significant-figure policy for values and their ± errors."""

    def __init__(self, sig_figs=4, separate_limit_tol=0.1, err_sf=2):
        self.sig_figs = sig_figs
        self.separate_limit_tol = separate_limit_tol
        self.err_sf = err_sf

    def _choose_sig_figs(self, value, limplus):
        """(value sig figs, error sig figs) adapted to the error scale."""
        rel = limplus / (abs(value) + limplus)
        sf = self.sig_figs
        if rel > 0.1 and 20 <= value < 100:
            sf = 2
        elif rel > 0.01 and value < 1000:
            sf = 3
        err_sf = 1 if (rel > 0.1 and value >= 20 and limplus >= 2) else self.err_sf
        return sf, err_sf

    def _match_decimals(self, value, res, sf, maxdp):
        """Re-format value so it has no more decimals than its errors."""
        while self.decimal_places(res) > maxdp:
            sf -= 1
            if sf == 0:
                res = "%.*f" % (maxdp, value)
                return ("%.*f" % (maxdp, 0) if float(res) == 0.0 else res), sf
            res = self.formatNumber(value, sf)
        return res, sf

    def namesigFigs(self, value, limplus, limminus, wantSign=True, sci=False):
        """Format value and the two limits with consistent decimal places
        (reference ``types.py:102-141``)."""
        sf, err_sf = self._choose_sig_figs(value, limplus)
        power = 0
        if sci:
            # probe the exponent from the largest-magnitude end of the range
            widest = max(abs(value - limminus), abs(value + limplus))
            if power := self.formatNumber(widest, sci=True)[1]:
                scale = float_to_decimal(10.0**-power)
                mul = decimal.getcontext().multiply
                value, limplus, limminus = (mul(float_to_decimal(v), scale) for v in (value, limplus, limminus))
        hi = self.formatNumber(limplus, err_sf, wantSign)
        lo = self.formatNumber(limminus, err_sf, wantSign)
        maxdp = max(self.decimal_places(hi), self.decimal_places(lo))
        res, sf = self._match_decimals(value, self.formatNumber(value, sf), sf, maxdp)
        while self.decimal_places(hi) > self.decimal_places(res):
            sf += 1
            res = self.formatNumber(value, sf)
        return (res, hi, lo, power) if sci else (res, hi, lo)

    def formatNumber(self, value, sig_figs=None, wantSign=False, sci=False):
        out = numberFigs(value, sig_figs if sig_figs else self.sig_figs, sci=sci)
        power = None
        if sci:
            out, power = out
        if wantSign:
            as_float = float(out)
            if as_float > 0:
                out = "+" + out
            elif as_float < 0 and not out.startswith("-"):
                out = "-" + out
        return (out, power) if sci else out

    def decimal_places(self, s):
        whole, dot, frac = s.partition(".")
        return len(frac) if dot and whole else 0

    def plusMinusLimit(self, limit, upper, lower):
        ratio = abs(upper / lower)
        return limit != 1 or abs(ratio - 1) > self.separate_limit_tol


# ---------------------------------------------------------------------------
# latex table machinery
# ---------------------------------------------------------------------------


class TableFormatter:
    """Lined latex table style.

    Style knobs are class attributes so variants are declared as plain
    subclass overrides; only derived pieces are computed per instance.
    """

    border = "|"
    endofrow = "\\\\"
    hline = "\\hline"
    paramText = "Parameter"
    aboveTitles = "\\hline"
    majorDividor = "|"
    minorDividor = "|"
    colDividor = "||"
    belowTitles = ""
    headerWrapper = " %s"
    noConstraint = "---"
    spacer = " "

    def __init__(self):
        self.colSeparator = self.spacer + "&" + self.spacer
        self.numberFormatter = NumberFormatter()

    def getLine(self, position=None):
        return getattr(self, position) if position and hasattr(self, position) else self.hline

    def belowTitleLine(self, colsPerParam, numResults=None):
        return self.getLine("belowTitles")

    def startTable(self, ncol, colsPerResult, numResults):
        block = self.majorDividor + (" c" + self.minorDividor) * (colsPerResult - 1) + " c"
        group = " l " + block * numResults
        inner = self.border + group + (self.colDividor + group) * (ncol - 1) + self.border
        return "\\begin{tabular} {%s}" % inner

    def endTable(self):
        return r"\end{tabular}"

    def titleSubColumn(self, colsPerResult, title):
        spec = self.majorDividor + "c" + self.majorDividor
        return " \\multicolumn{%s}{%s}{%s}" % (colsPerResult, spec, self.formatTitle(title))

    def formatTitle(self, title):
        return r"\bf " + texEscapeText(title)

    def texEquation(self, txt):
        return txt if not txt or txt.startswith("$") else "$" + txt + "$"

    def textAsColumn(self, txt, latex=False, separator=False, bold=False):
        pad = 28 - len(txt) - (2 if latex else 0) - (11 if latex and bold else 0)
        cell = txt + self.spacer * max(0, pad)
        if latex:
            cell = self.texEquation(cell)
            if bold:
                cell = r"{\boldmath" + cell + "}"
        return cell + self.colSeparator if separator else cell


class OpenTableFormatter(TableFormatter):
    """Open (no side borders) latex table style."""

    border = ""
    aboveTitles = r"\noalign{\vskip 3pt}\hline\noalign{\vskip 1.5pt}\hline\noalign{\vskip 5pt}"
    belowTitles = r"\noalign{\vskip 3pt}\hline"
    aboveHeader = ""
    belowHeader = r"\hline"
    minorDividor = ""
    belowFinalRow = ""

    def titleSubColumn(self, colsPerResult, title):
        return " \\multicolumn{%s}{c}{%s}" % (colsPerResult, self.formatTitle(title))


class NoLineTableFormatter(OpenTableFormatter):
    """Minimal-rule latex table style (the default)."""

    aboveHeader = ""
    minorDividor = ""
    majorDividor = ""
    belowFinalRow = r"\hline"
    belowBlockRow = r"\hline"
    colDividor = "|"
    hline = ""

    def belowTitleLine(self, colsPerParam, numResults=None):
        last = colsPerParam * numResults + 1
        return r"\noalign{\vskip 3pt}\cline{2-%d}\noalign{\vskip 3pt}" % last


class ResultTable:
    """A latex table of parameter statistics (multi-column, multi-result)."""

    def __init__(
        self, ncol, results, limit=2, tableParamNames=None, titles=None, formatter=None, numFormatter=None,
        blockEndParams=None, paramList=None, refResults=None, shiftSigma_indep=False, shiftSigma_subset=False
    ):
        """
        :param ncol: number of columns
        :param results: MargeStats/BestFit instance(s) (or objects exposing
            getMargeStats, e.g. MCSamples)
        :param limit: which stored limit to show (1 = 68%, 2 = 95% ...)
        :param tableParamNames: ParamNames restricting rows
        :param titles: per-result column titles
        :param formatter: a TableFormatter instance
        :param numFormatter: a NumberFormatter instance
        :param blockEndParams: parameter names ending visual blocks
        :param paramList: parameter name strings to include
        :param refResults: reference MargeStats for σ-shift annotations
        :param shiftSigma_indep: show shifts assuming independent data
        :param shiftSigma_subset: show shifts assuming nested data
        """
        results = [res.getMargeStats() if hasattr(res, "getMargeStats") else res for res in makeList(results)]
        self.lines = []
        self.format = formatter or NoLineTableFormatter()
        if numFormatter:
            self.format.numFormatter = numFormatter
        row_source = tableParamNames if tableParamNames is not None else results[0]
        self.tableParamNames = row_source.filteredCopy(paramList) if paramList is not None else row_source
        self.ncol, self.limit, self.results = ncol, limit, results
        self.boldBaseParameters = True
        self.colsPerResult = len(results[0].getColumnLabels(limit))
        self.colsPerParam = len(results) * self.colsPerResult
        self.refResults = refResults
        self.shiftSigma_indep, self.shiftSigma_subset = shiftSigma_indep, shiftSigma_subset

        self._layout_rows(blockEndParams, titles)

    def _layout_rows(self, blockEndParams, titles):
        """Column-major row layout, then emit all table lines."""
        names = self.tableParamNames.names
        numrow = -(-len(names) // self.ncol)
        strides = [names[c * numrow : (c + 1) * numrow] for c in range(self.ncol)]
        rows = [[col[r] for col in strides if r < len(col)] for r in range(numrow)]

        self.lines.append(self.format.startTable(self.ncol, self.colsPerResult, len(self.results)))
        if titles is not None:
            self.addTitlesRow(titles)
        self.addHeaderRow()
        block_ends = blockEndParams if self.ncol == 1 and blockEndParams is not None else ()
        for row in rows[:-1]:
            self.addFullTableRow(row)
            self.addLine("belowBlockRow" if row[0].name in block_ends else "belowRow")
        self.addFullTableRow(rows[-1])
        self.addLine("belowFinalRow")
        self.endTable()

    def _emit_row(self, cells):
        self.lines.append(self.format.colSeparator.join(cells) + self.format.endofrow)

    def addFullTableRow(self, row):
        cells = [self.paramLabelColumn(param) + self.paramResultsTex(param) for param in row]
        short = self.ncol - len(row)
        if short:
            cells[-1] += self.format.colSeparator * ((1 + self.colsPerParam) * short)
        self._emit_row(cells)

    def addLine(self, position):
        rule = self.format.getLine(position)
        return self.lines if rule is None else self.lines.append(rule)

    def addTitlesRow(self, titles):
        self.addLine("aboveTitles")
        cols = [self.format.titleSubColumn(1, "")]
        cols.extend(self.format.titleSubColumn(self.colsPerResult, name) for name in titles)
        self._emit_row(cols * self.ncol)
        rule = self.format.belowTitleLine(self.colsPerResult, self.colsPerParam // self.colsPerResult)
        if rule:
            self.lines.append(rule)

    def addHeaderRow(self):
        self.addLine("aboveHeader")
        wrap = self.format.headerWrapper.__mod__
        cols = [wrap(self.format.paramText)]
        for result in self.results:
            cols.extend(wrap(s) for s in result.getColumnLabels(self.limit))
        self._emit_row(cols * self.ncol)
        self.addLine("belowHeader")

    def paramResultsTex(self, param):
        return self.format.colSeparator.join(self.paramResultTex(result, param) for result in self.results)

    def paramResultTex(self, result, p):
        values = result.texValues(
            self.format, p, self.limit, self.refResults,
            shiftSigma_subset=self.shiftSigma_subset, shiftSigma_indep=self.shiftSigma_indep,
        )
        if values is None:
            return self.format.textAsColumn("") * len(result.getColumnLabels(self.limit))
        txt = self.format.textAsColumn(values[1], True, separator=True) if len(values) > 1 else ""
        return txt + self.format.textAsColumn(values[0], values[0] != self.format.noConstraint)

    def paramLabelColumn(self, param):
        return self.format.textAsColumn(param.getLabel(), True, separator=True, bold=not param.isDerived)

    def endTable(self):
        self.lines.append(self.format.endTable())

    def tableTex(self, document=False, latex_preamble=None, packages=("amsmath", "amssymb", "bm")):
        """Latex string for the table (full document if requested)."""
        if not document:
            return "\n".join(self.lines)
        doc = [r"\documentclass{article}", r"\pagestyle{empty}"]
        doc.extend(r"\usepackage{%s}" % package for package in packages)
        doc.append(r"\renewcommand{\arraystretch}{1.5}")
        if latex_preamble:
            doc.append(latex_preamble)
        return "\n".join(doc + [r"\begin{document}"] + self.lines + [r"\end{document}"])

    def write(self, fname, **kwargs):
        """Write the latex to a file."""
        TextFile(self.tableTex(**kwargs)).write(fname)

    def tablePNG(self, dpi=None, latex_preamble=None, filename=None, bytesIO=False):
        """Render the table to PNG via latex + dvipng (requires latex)."""
        import subprocess

        texfile = tempfile.mktemp(suffix=".tex")
        self.write(texfile, document=True, latex_preamble=latex_preamble)
        stem = os.path.splitext(texfile)[0]
        outfile = filename or stem + ".png"
        here = os.getcwd()

        def run_tool(command):
            flags = subprocess.CREATE_NO_WINDOW if os.name == "nt" else 0
            try:
                quiet = dict(stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
                subprocess.run(command, creationflags=flags, check=True, **quiet)
            except FileNotFoundError:
                tool = command[0] if command else "Command"
                message = f"Command not found: {tool}"
                if tool == "latex":
                    message += (
                        "\nLaTeX must be installed to generate tables. "
                        "Please install a TeX distribution like TeX Live, MiKTeX, or MacTeX."
                    )
                elif tool == "dvipng":
                    message += (
                        "\ndvipng must be installed to generate PNG images. "
                        "It is included in most LaTeX distributions."
                    )
                raise FileNotFoundError(message)

        try:
            os.chdir(os.path.dirname(texfile))
            run_tool(["latex", texfile])
            raster = ["dvipng"] + (["-D", str(dpi)] if dpi else [])
            raster += ["-T", "tight", "-x", "1000", "-z", "9", "--truecolor", "-o", outfile, stem + ".dvi"]
            run_tool(raster)
        finally:
            for scratch in (stem + ext for ext in (".tex", ".dvi", ".aux", ".log")):
                if os.path.isfile(scratch):
                    os.remove(scratch)
            os.chdir(here)
        if bytesIO:
            buffer = BytesIO(Path(outfile).read_bytes())
            os.remove(outfile)
            buffer.seek(0)
            return buffer
        return outfile
