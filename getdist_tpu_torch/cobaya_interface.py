"""Cobaya interoperability: yaml info parsing and in-memory sample import.

The port's own copy of ``getdist_tpu/cobaya_interface.py`` (role of the
reference's ``getdist/cobaya_interface.py``): reads Cobaya
``*.updated.yaml`` / ``*__full.yaml`` info files, classifies sampled and
derived parameters, extracts prior ranges (including scipy.stats
distribution intervals and periodic flags), the sampler type, temperature,
label and post-processing burn-in, and builds the port's ``MCSamples``
from live Cobaya collection objects on a torch device (the card unless
the caller names the CPU).

Nothing here imports yaml until a file name is given, nor pandas: a
collection's columns are read through ``c[name].values`` and
``c.data.columns``, which a pandas ``DataFrame`` and any numpy-backed
stand-in both offer.

Two faults of the JAX module are not copied: the parameter-label and
renames keys that its ``ParamNames`` reads (``_p_label``, ``_p_renames``)
are defined here, so an on-disk Cobaya root loads (ROADMAP C20), and
:func:`get_burn_removed` reads the info's ``post: skip`` rather than the
parameter table's (C21).
"""

import logging
import os
from collections.abc import Mapping, Sequence
from copy import deepcopy
from importlib import import_module
from numbers import Number

import numpy as np

# Cobaya yaml block/key names that appear in several places
_params = "params"
_prior = "prior"
_post = "post"
_sampler = "sampler"
_chi2 = "chi2"
_minuslogprior = "minuslogprior"
_p_label = "latex"
_p_renames = "renames"

__all__ = [
    "cobaya_params_file",
    "MCSamplesFromCobaya",
    "get_info_params",
    "get_range",
    "is_sampled_param",
    "is_derived_param",
    "expand_info_param",
    "get_sampler_type",
    "get_sampler_temperature",
    "get_sample_label",
    "get_burn_removed",
]


def cobaya_params_file(root):
    """Path of the Cobaya yaml info file for a chain root, or None."""
    trailing = root.endswith((os.sep, "/"))
    for joiner, suffix in ((".", "updated.yaml"), ("__", "full.yaml")):
        candidate = root + ("" if trailing else joiner) + suffix
        if os.path.exists(candidate):
            return candidate
    return None


def yaml_file_or_dict(source) -> Mapping:
    """The info dict itself, or the dict loaded from a yaml file name."""
    if isinstance(source, Mapping):
        return source
    if isinstance(source, str):
        from getdist_tpu_torch.yaml_tools import yaml_load_file

        return yaml_load_file(source)
    raise ValueError("Cobaya parameter input must be a dictionary or filename")


def str_to_list(x):
    if isinstance(x, str):
        return [x]
    return x


def expand_info_param(info_param):
    """Normalize a parameter's info to the unambiguous dict form."""
    if isinstance(info_param, Mapping):
        expanded = deepcopy(info_param)
    else:
        expanded = {} if info_param is None else {"value": info_param}
    if not any(field in expanded for field in (_prior, "value", "derived")):
        expanded["derived"] = True
    value = expanded.get("value")
    if isinstance(value, str) or callable(value):
        expanded.setdefault("derived", True)
    return expanded


def is_sampled_param(info_param):
    """True if the parameter has a prior (is sampled)."""
    return _prior in expand_info_param(info_param)


def is_derived_param(info_param):
    """True if the parameter is stored as derived."""
    return expand_info_param(info_param).get("derived", False)


def _tex_subscripted(prefix, component):
    return {_p_label: prefix + r"_\mathrm{" + component.replace("_", r"\ ") + r"}"}


def get_info_params(info):
    """Full parameter info dict from Cobaya yaml info, including the
    minuslogprior/chi2 per-component derived entries and post-processing
    add/remove blocks."""
    spec = yaml_file_or_dict(info)
    table = dict(spec.get(_params) or {})
    priors = ["0"] + list(spec.get(_prior) or [])
    likes = list(spec.get("likelihood") or [])

    post_remove = spec.get(_post, {}).get("remove", {})
    for name in post_remove.get(_params, []) or []:
        table.pop(name, None)
    for name in str_to_list(post_remove.get("likelihood") or []):
        likes.remove(name)
    for name in str_to_list(post_remove.get(_prior)) or []:
        priors.remove(name)

    post_add = spec.get(_post, {}).get("add", {})
    for name, extra in post_add.get(_params, {}).items():
        merged = table.get(name, {})
        merged.update(extra)
        table[name] = merged
    likes += list(post_add.get("likelihood", []))
    priors += list(post_add.get(_prior, []))

    table[_minuslogprior] = {_p_label: r"-\log\pi"}
    table.update({_minuslogprior + "__" + p: _tex_subscripted(r"-\log\pi", p) for p in priors})
    table[_chi2] = {_p_label: r"\chi^2"}
    table.update({_chi2 + "__" + like: _tex_subscripted(r"\chi^2", like) for like in likes})
    return table


def get_range(param_info):
    """(lower, upper, periodic) for a parameter's prior; None = unbounded.

    Supports explicit min/max, [min, max] lists, and loc/scale scipy.stats
    distributions via their full interval.
    """
    spec = expand_info_param(param_info if param_info else {})
    periodic = spec.get("periodic", False)
    if not is_sampled_param(spec):
        value = spec.get("value")
        if isinstance(value, Number):
            fixed = float(value)
            return fixed, fixed, False
        bounds = tuple(spec.get(edge) for edge in ("min", "max"))
        return bounds[0], bounds[1], periodic

    prior = spec[_prior]
    if isinstance(prior, Mapping):
        prior = dict(prior)
    elif isinstance(prior, Sequence) and len(prior) == 2:
        prior = dict(zip(("min", "max"), prior))
    else:
        raise ValueError(
            "Format of prior not recognised: %r. "
            "Use '[min, max]' or a dictionary following Cobaya's documentation." % (prior,)
        )
    if prior.pop("periodic", False):
        periodic = True
    if prior.get("min") is not None or prior.get("max") is not None:
        lo, hi = prior.get("min"), prior.get("max")
    elif prior.get("loc") is not None or prior.get("scale") is not None:
        spec = dict(prior)
        dist_name = spec.pop("dist", "uniform")
        family = getattr(import_module("scipy.stats", dist_name), dist_name)
        lo, hi = family.interval(1, **spec)
    else:
        lo = hi = None
    return (None if lo == -np.inf else lo, None if hi == np.inf else hi, periodic)


def get_sampler_key(filename_or_info, default_sampler_for_chain_type="mcmc"):
    declared = yaml_file_or_dict(filename_or_info).get(_sampler, [default_sampler_for_chain_type])
    return next(iter(declared))


def get_sampler_type(filename_or_info, default_sampler_for_chain_type="mcmc"):
    """Sampler type string ('mcmc'/'nested'/...), polychord mapped to nested."""
    key = get_sampler_key(filename_or_info, default_sampler_for_chain_type)
    declared = yaml_file_or_dict(filename_or_info).get(_sampler, {}).get(key, {}).get("sampler_type")
    if declared is not None:
        return declared
    return "nested" if key == "polychord" else key


def get_sampler_temperature(filename_or_info):
    """Sampling temperature, 1 for post-processed chains, None if unknown."""
    spec = yaml_file_or_dict(filename_or_info)
    if _sampler not in spec:
        return None
    if _post in spec:
        return 1
    block = spec[_sampler][get_sampler_key(spec)] or {}
    return block.get("temperature")


def get_sample_label(filename_or_info):
    return yaml_file_or_dict(filename_or_info).get("label")


def _post_skip(info):
    return info.get(_post, {}).get("skip", 0)


def get_burn_removed(filename_or_info):
    """The burn-in a post-processing run already skipped (its ``post:
    skip``), 0 when none."""
    return _post_skip(yaml_file_or_dict(filename_or_info))


def _validated_columns(collections):
    """Shared column list of the collection(s), with type checks."""
    first, *rest = collections
    try:
        columns = list(first.data)
    except AttributeError:
        raise TypeError("collections must be a Cobaya samples `Collection` (or a list of them)")
    for other in rest:
        if list(other.data) != columns:
            raise ValueError("the collections have mismatched columns")
    return columns


def MCSamplesFromCobaya(info, collections, name_tag=None, ignore_rows=0, ini=None, settings=None, device="cuda"):
    """Build :class:`~.mcsamples.MCSamples` from Cobaya run output.

    :param info: updated info dict from ``cobaya.run`` (or yaml filename)
    :param collections: Cobaya SampleCollection(s)
    :param name_tag: legend name for the sample
    :param ignore_rows: burn-in rows (int) or fraction (float < 1)
    :param ini: .ini analysis settings filename
    :param settings: dict of analysis setting overrides
    :param device: torch device of the samples' analysis, the card unless
        the caller names the CPU (raises without CUDA)
    """
    if hasattr(collections, "data"):
        collections = [collections]
    columns = _validated_columns(collections)
    info_params = get_info_params(info)

    skip = _post_skip(info)
    if skip and ignore_rows:
        msg = (
            "You are asking for rows to be ignored (%r), but some (%r) "
            "were already ignored in the original chain."
        )
        logging.warning(msg, ignore_rows, skip)

    # columns[0:2] are weight and -log(post); the rest must match the info
    sample_columns = columns[2:]
    var_params = [name for name, spec in info_params.items() if is_sampled_param(spec) or is_derived_param(spec)]
    if set(sample_columns) != set(var_params):
        raise AssertionError(
            "Info and collection(s) are not compatible, because their parameters "
            "differ: the collection(s) have %r and the info has %r. Are you sure "
            "that you are using an *updated* info dictionary (i.e. the output of "
            "`cobaya.run`)?" % (sample_columns, var_params)
        )

    names = [name + ("*" if is_derived_param(info_params[name]) else "") for name in sample_columns]
    labels = [(info_params[name] or {}).get(_p_label, name) for name in sample_columns]
    ranges = {name: get_range(spec) for name, spec in info_params.items()}
    renames = {name: info_params.get(name, {}).get(_p_renames, []) for name in sample_columns}

    as_f64 = lambda c, what: c[what].values.astype(np.float64)  # noqa: E731
    samples = [as_f64(c, c.data.columns[2:]) for c in collections]
    weights = [as_f64(c, "weight") for c in collections]
    loglikes = [as_f64(c, "minuslogpost") for c in collections]

    temperature = get_sampler_temperature(info)
    if temperature not in (None, 1):
        msg = (
            "You have loaded a sample with non-unit temperature. Use the "
            "'MCSamples.cool()' method to turn it into a sample from the original "
            "posterior before performing statistical analyses, but maybe after "
            "thinning the sample with method 'MCSamples.thin_indices()'."
        )
        logging.warning(msg)
    from getdist_tpu_torch.mcsamples import MCSamples

    return MCSamples(
        samples=samples, weights=weights, loglikes=loglikes, sampler=get_sampler_type(info),
        names=names, labels=labels, ranges=ranges, renames=renames, ignore_rows=ignore_rows,
        name_tag=name_tag, label=get_sample_label(info), ini=ini, temperature=temperature,
        settings=settings, device=device,
    )
