"""Matplotlib extensions: bounded tick location and full-sci-notation labels.

Behavior-compatible with the reference ``getdist/matplotlib_ext.py:9-382``
(tick-for-tick parity is regression-tested): ``BoundedMaxNLocator`` keeps
marks strictly inside the axis bounds, prunes labels that would collide with
the host ends (using an estimated label length from character count and font
aspect), falls back through "less nice" spacing groups, and guarantees at least
two marks where possible, even at odd spacings or half-phase offsets.
``SciFuncFormatter`` renders full scientific notation inside each tick label
instead of an origin text.
"""

import bisect
import math

import numpy as np
from matplotlib import ticker

__all__ = ["BoundedMaxNLocator", "SciFuncFormatter"]

# minimum label extent in character units used in spacing heuristics
_min_label_len_chars = 1.35

_POINTS_PER_INCH = 72.0


def _across_decades(values, group):
    """Extend a spacing group across neighboring decades (0.1x, 1x, 10x),
    dropping the duplicated endpoints when the group already spans one."""
    if len(group) > 1 and 10 * group[0] == group[-1]:
        parts = (0.1 * values[:-1], values, 10 * values[1:])
    else:
        parts = (0.1 * values, values, 10 * values)
    return np.hstack(parts)


def _half_phase(step):
    """Offset usable for a half-phase comb (0 when the step is odd)."""
    return step // 2 if step % 2 < 1e-6 else 0


def _snap_tol(origin, spacing):
    """Edge-snapping tolerance for spacing-index rounding."""
    if origin > 0:
        digits = np.log10(origin / spacing)
        return min(0.4999, max(1e-10, 10 ** (digits - 12)))
    return 1e-10


def _last_index(x, origin, spacing):
    """Largest n with n*spacing <= x (snapping near-exact multiples)."""
    n, remainder = divmod(x, spacing)
    if abs(remainder / spacing - 1) < _snap_tol(abs(origin), spacing):
        return n + 1
    return n


def _first_index(x, origin, spacing):
    """Smallest n with n*spacing >= x (snapping near-exact multiples)."""
    n, remainder = divmod(x, spacing)
    if abs(remainder / spacing) < _snap_tol(abs(origin), spacing):
        return n
    return n + 1


def _axis_font_geometry(axis):
    """(font-size / axis-length-in-points, label angle in degrees)."""
    tick = axis._get_tick(True)
    angle = tick._labelrotation[1]
    vertical = int(axis.axis_name == "y")
    if vertical:
        angle += 90
    frame = axis.axes
    unit = [0, 0]
    unit[vertical] = 1
    span = frame.transAxes.transform([(0, 0), tuple(unit)])
    length_pts = abs(span[1][vertical] - span[0][vertical]) / frame.figure.dpi * _POINTS_PER_INCH
    return tick.label1.get_size() / length_pts, angle


_DEFAULT_STEP_GROUPS = ((1, 2, 5, 10), (2.5, 3, 4, 6, 8), (1.5, 7, 9))


class BoundedMaxNLocator(ticker.MaxNLocator):
    """Tick locator that only returns marks inside the axis bounds.

    Pruned marks never overlap the host ends; long labels are measured (by
    character count x font aspect) and the spacing re-solved to avoid
    label collisions or large tick-free gaps; fallback spacing groups and
    half-phase offsets are tried so at least two marks appear whenever they
    can fit.
    """

    default_step_groups = _DEFAULT_STEP_GROUPS

    def __init__(self, nbins="auto", prune=True, step_groups=default_step_groups):
        self.bounded_prune = prune
        groups = [np.asarray(g, dtype=float) for g in step_groups]
        self._ladders = [_across_decades(g, tuple(g)) for g in groups]
        self._offsets = [
            _across_decades(np.array([_half_phase(s) for s in g]), tuple(g)) for g in groups
        ]
        ticker.MaxNLocator.__init__(self, nbins=nbins, steps=list(step_groups[0]))

    def tick_values(self, lo_edge, hi_edge):
        # MaxNLocator alone can put marks outside or too close to the axis
        # bounds, and its default aspect heuristic ignores actual label
        # width. Measure the label geometry, cut out-of-bound points, and
        # re-solve the spacing when labels are long or gaps are large.
        font_ratio, angle = _axis_font_geometry(self.axis)
        upright = abs(math.cos(angle * math.pi / 180.0))
        span = hi_edge - lo_edge
        self._glyph_aspect = 0.65 * upright
        self._char_unit = font_ratio * span
        self._label_fmt = self.axis.major.formatter
        self._view = (lo_edge, hi_edge)

        # first-guess label geometry
        if upright > 0.05:
            label_span = 1.5 * font_ratio * span
            slot = label_span * 1.1
        else:
            # text orthogonal to the axis
            label_span = _min_label_len_chars * font_ratio * span
            slot = label_span * 1.25

        margin = self._margin(label_span)
        room = span - 2 * margin
        want = int(room / slot) + 1
        if want > 4:
            # leave more space between marks
            want = int(room / (slot * (1.5 if want > 6 else 1.3))) + 1
        need = min(want, 2)
        if self._nbins != "auto":
            want = min(self._nbins, want)
        else:
            want = min(9, want)
        # typical marks first, so the actual label length can be measured
        while True:
            marks, _ = self._candidate_marks(lo_edge + margin, hi_edge - margin, label_span, need, want, False)
            if len(marks) or need == 1:
                break
            if want == 2:
                need -= 1
            want = max(need, 2)

        scalar_labels = isinstance(self._label_fmt, ticker.ScalarFormatter)
        if not (upright > 0.05 and scalar_labels and len(marks) > 1):
            return self._drop_edge_marks(marks, label_span)

        label_span = self._label_extent(marks)
        marks = self._drop_edge_marks(marks, label_span)
        if len(marks) > 1:
            spacing = marks[1] - marks[0]
        # re-solve on long labels, too-tight spacing, or big end gaps
        # (note: spacing is only read when >= 3 marks survived the prune)
        crowded = len(marks) >= max(3, want) and spacing < label_span * (1.1 if len(marks) < 4 else 1.5)
        end_gappy = len(marks) >= max(3, want) and (
            marks[0] - lo_edge > min(spacing * 1.01, label_span * 1.5)
            or hi_edge - marks[-1] > min(spacing * 1.01, label_span * 1.5)
        )
        if len(marks) < max(3, want) or crowded or end_gappy:
            marks = self._resolve_spacing(lo_edge, hi_edge, label_span, need, font_ratio)
        return marks

    def _resolve_spacing(self, lo_edge, hi_edge, label_span, need, font_ratio):
        """Re-derive tick spacing from the measured label length, dropping
        the minimum tick count as needed, with last-resort fallbacks."""
        margin = self._margin(label_span)
        span = hi_edge - lo_edge
        for fac in (1.5, 1.35, 1.1):
            want = int((span - 2 * margin) / (fac * max(2 * self._char_unit, label_span))) + 1
            if want >= 4:
                break
        if self._nbins != "auto":
            want = min(self._nbins, want)
        need = min(need, want)
        allow_refit = True
        allow_shorter = True
        marks = []
        while need > 1:
            marks, settled = self._candidate_marks(lo_edge + margin, hi_edge - margin, label_span, need, want)
            if len(marks):
                if not settled:
                    measured = self._label_extent(marks)
                    if not np.isclose(measured, label_span):
                        label_span = measured
                        margin = self._margin(label_span)
                        if allow_refit:
                            allow_refit = False
                            continue
                        marks = self._drop_edge_marks(marks, label_span)
            elif need > 1 and allow_shorter:
                # the assumed label length may be blocking marks that exist
                margin *= 0.5
                label_span *= 0.5
                allow_shorter = False
                marks, _ = self._candidate_marks(lo_edge + margin, hi_edge - margin, label_span, need, want)
                if len(marks):
                    label_span = self._label_extent(marks)
                    margin = self._margin(label_span)
                    continue
            if (
                need == 1
                and len(marks) == 1
                or len(marks) >= need > 1
                and marks[1] - marks[0] > self._label_extent(marks) * 1.1
            ):
                break
            need -= 1
            marks = []
        if len(marks) <= 1 and font_ratio * self._glyph_aspect < 0.9:
            decade, _ = ticker.scale_range(lo_edge, hi_edge, 1)
            # any two round points that fit
            for unit in (decade, 0.1 * decade):
                quarter = (3 * lo_edge + hi_edge) / 4
                three_quarter = (lo_edge + 3 * hi_edge) / 4
                marks = [round(quarter / unit) * unit, round(three_quarter / unit) * unit]
                if marks[0] != marks[1] and marks[0] >= lo_edge and marks[1] <= hi_edge:
                    if self._fits(marks):
                        return marks
            # or a single short round number somewhere in range (may have
            # been rejected only because companions lengthen the labels)
            center = round((lo_edge + hi_edge) / (2 * decade)) * decade
            if lo_edge < center < hi_edge:
                marks = [center]
                return self._drop_edge_marks(marks, self._label_extent(marks))
        return marks

    def _fits(self, marks):
        label_span = self._label_extent(marks)
        spaced = len(marks) < 2 or marks[1] - marks[0] > label_span * 1.1
        if not self.bounded_prune:
            return spaced
        return (
            spaced
            and marks[0] - self._view[0] > 0.5 * label_span
            and self._view[1] - marks[-1] > 0.5 * label_span
        )

    def _candidate_marks(self, lo_edge, hi_edge, seed_len, need_marks, want, remeasure=True):
        """Choose tick positions in [lo_edge, hi_edge] from the spacing groups.

        Returns (marks, settled): settled=True means the spacing was
        accepted outright; False means it is the keeper-scoring compromise
        (caller may re-measure labels and retry). Candidates walk nice
        ladder first, then coarser groups and half-phase offsets, scoring
        down crowding, big end gaps, and sparse coverage.
        """
        decade, origin = ticker.scale_range(lo_edge, hi_edge, want)
        lo = lo_edge - origin
        hi = hi_edge - origin
        width = hi - lo
        snap = width * 1e-6
        axis_span = self._view[1] - self._view[0]
        # a round value near the centre to pivot less-nice ladder on
        for unit in (100, 10, 1):
            pivot = round((lo + hi) / (2 * unit * decade)) * unit * decade
            if lo - snap <= pivot <= hi + snap:
                break

        label_span = seed_len * 1.1
        cap_step = max(label_span, width / ((want - 2) if want > 2 else 1))
        slots = want if self.bounded_prune else want - 1
        fill_step = width / max(1, slots)
        keeper = []
        keeper_score = -np.inf
        for family in range(len(self._ladders)):
            ladder = self._ladders[family] * decade
            family_offsets = self._offsets[family]
            if family and len(keeper) < 3:
                cap_step = max(cap_step, width / 2)
            top = min(len(ladder) - 1, bisect.bisect_left(ladder, cap_step))
            if not top:
                continue
            # walk down from the upper-limit spacing; half-phase pass second
            for halfstep in (False, True):
                if halfstep and (len(keeper) > 2 or len(keeper) == 2 and (not pivot or family > 1)):
                    break
                for i in reversed(range(top + 1)):
                    if halfstep and not family_offsets[i]:
                        continue
                    spacing = ladder[i]
                    if spacing < label_span:
                        break

                    if family and lo <= pivot <= hi:
                        # hit round numbers in range with less-nice ladder
                        base = pivot - ((pivot - lo) // spacing) * spacing
                    else:
                        base = (lo // spacing) * spacing
                    if halfstep:
                        # e.g. -x/2, x/2 instead of -x, 0, x
                        nudge = decade * family_offsets[i]
                        base += nudge if base - nudge < lo else -nudge

                    unit = 10 ** (math.log10(spacing) // 1)
                    units = round(spacing / unit)
                    first = _first_index(lo - base, origin, spacing)
                    last = _last_index(hi - base, origin, spacing)
                    count = last - first + 1
                    if count < need_marks or count > want:
                        continue
                    cand = np.arange(first, last + 1) * spacing + (base + origin)

                    if halfstep and pivot and remeasure and spacing > 2 * unit:
                        # budge the comb to include a round number if possible
                        for budge in (0, -1, 1, -2, 2):
                            if abs(budge * unit) >= spacing / 2:
                                break
                            moved = cand + budge * unit
                            rounded = np.round(moved / unit)
                            if any(np.round(rounded / 10) * 10 == rounded) and self._fits(moved):
                                cand = moved

                    flaws = self._assess(
                        cand, spacing, units, unit, label_span, fill_step, axis_span, need_marks, want, family
                    )
                    beaten = min(3, len(cand)) <= len(keeper)
                    if (flaws["sparse"] and flaws["gappy"] or flaws["crowded"]) and beaten:
                        continue
                    if len(keeper) and flaws["gappy"] and family or remeasure and not self._fits(cand):
                        continue
                    score = self._score(cand, ladder, units, family, halfstep, flaws)
                    if score <= keeper_score:
                        continue
                    compromise = (
                        halfstep
                        and not family
                        or flaws["sparse"]
                        and (not len(keeper) or len(cand) < len(keeper))
                        or flaws["crowded"]
                        or flaws["scanty"]
                        or flaws["gappy"]
                    )
                    if not compromise:
                        return cand, True
                    # keep as compromise; prefer marks near the ends and not
                    # too close together in the centre
                    keeper = cand
                    keeper_score = score
        return keeper, False

    def _assess(self, cand, spacing, units, unit, label_span, fill_step, axis_span, need_marks, want, family):
        """Flag layout defects of a candidate tick comb."""
        end_gap_limit = max(min(axis_span / 3, spacing), label_span * 1.1)
        wide_pair = len(cand) == 2 and spacing > axis_span * 0.7
        if need_marks <= 1:
            gappy = False
        elif self.bounded_prune:
            gappy = wide_pair or (
                cand[0] - self._view[0] > end_gap_limit or self._view[1] - cand[-1] > end_gap_limit
            )
        else:
            gappy = wide_pair or (
                len(cand) == 3
                and spacing > max(2 * label_span, axis_span / 3)
                and units > 1
                and round(cand[-1] / unit) % 10 > 0
            )
        few = len(cand) < 3 and (want > (3 if family else 4)) or (len(cand) < max(2, (want + 1) // 2))
        return {
            "sparse": spacing > fill_step and spacing > label_span * 1.5,
            "gappy": gappy,
            "crowded": spacing < label_span * 1.3 and len(cand) > 2,
            "scanty": few and spacing > label_span * 1.5,
        }

    @staticmethod
    def _score(cand, ladder, units, family, halfstep, flaws):
        """Rank a compromise candidate (higher is better)."""
        score = -1 * flaws["scanty"] - family * 2 - flaws["crowded"] * 2 - flaws["gappy"] * 1
        if len(cand) < 3 and flaws["sparse"]:
            score -= 2
        if halfstep:
            score -= 3
        if units == 1.0 and not halfstep:
            score += 1
        if 0.0 in ladder:
            score += 1
        return score

    def _margin(self, label_span):
        """Half-label end margin (zero when pruning is off)."""
        return 0.5 * label_span if self.bounded_prune else 0.0

    def _drop_edge_marks(self, marks, label_span):
        if len(marks) > 1 and self.bounded_prune:
            lo_gap = marks[0] - self._view[0]
            if lo_gap < 0.5 * label_span:
                marks = marks[1:]
            if len(marks) > 1 and self._view[1] - marks[-1] < 0.5 * label_span:
                marks = marks[:-1]
        return marks

    @staticmethod

    def _label_width_chars(fmt, value):
        text = fmt % value
        width = len(text)
        if "." in text:
            width -= 0.4
        return width

    def _label_extent(self, marks):
        """Estimated label extent in data units for these tick values."""
        if not len(marks):
            return 0
        self._label_fmt.set_locs(marks)
        # extract the non-latex % format from the formatter
        template = self._label_fmt.format
        start = template.index("%")
        fmt = template[start : template.index("f", start) + 1]
        chars = max(self._label_width_chars(fmt, m) for m in (marks[0], marks[-1]))
        return max(_min_label_len_chars, chars * self._glyph_aspect) * self._char_unit

class SciFuncFormatter(ticker.Formatter):
    """Tick formatter writing full scientific notation in each label."""

    def __call__(self, x, pos=None):
        inner = self._format_sci_notation("%.10e" % x)
        return f"${inner}$"

    def format_data(self, value):
        # plain text (e.g. navigation toolbar)
        return format(value, "<8g")

    @staticmethod
    def _format_sci_notation(s):
        # compact "1e+004" style into latex "10^{4}" style
        mantissa, _, expo = s.partition("e")
        try:
            power = int(expo)
        except ValueError:
            return s
        mantissa = mantissa.rstrip("0").rstrip(".")
        power_tex = "10^{%d}" % power if power else ""
        if mantissa == "1" and power_tex:
            mantissa = ""
        if mantissa and power_tex:
            return r"%s{\times}%s" % (mantissa, power_tex)
        return mantissa + power_tex
