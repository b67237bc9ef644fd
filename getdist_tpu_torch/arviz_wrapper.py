"""ArviZ / PyMC bridge: InferenceData -> MCSamples.

The port's own copy of ``getdist_tpu/arviz_wrapper.py`` (role of the
reference's ``getdist/arviz_wrapper.py``): flattens multi-dimensional
posterior variables (``theta`` -> ``theta_0``..), names and labels
parameters coordinate-aware, and preserves per-chain arrays, optional
weights and log-likelihood variables, into the port's ``MCSamples`` on a
torch device (the card unless the caller names the CPU). Neither arviz nor
xarray is imported: ``idata`` is read through its groups' ``sizes``,
``data_vars``, ``dims``, ``coords`` and ``values``, which an
``InferenceData`` and any duck-typed stand-in offer.
"""

import numpy as np

from getdist_tpu_torch.mcsamples import MCSamples

__all__ = ["arviz_to_mcsamples"]


# latex-special characters and their escaped forms, applied in order
# (backslash first so the escapes themselves survive)
_TEX_ESCAPES = {
    "\\": r"\textbackslash{}",
    "{": r"\{",
    "}": r"\}",
    "_": r"\_",
    "^": r"\^{}",
    "~": r"\textasciitilde{}",
    "%": r"\%",
    "$": r"\$",
    "#": r"\#",
    "&": r"\&",
}


def _escape_latex_text(text: str) -> str:
    for char, escaped in _TEX_ESCAPES.items():
        text = text.replace(char, escaped)
    return text


def _default_scalar_label(var_name):
    if var_name.startswith("\\"):
        return var_name
    return rf"\text{{{var_name.replace('_', chr(92) + '_')}}}"


def _coord_subscript(data_array, core_dim_names, multi_idx):
    """Latex subscript components from coordinate values/indices."""
    parts = []
    if len(core_dim_names) == len(multi_idx):
        for dim_idx, dim_name in enumerate(core_dim_names):
            idx = multi_idx[dim_idx]
            if dim_name in data_array.coords:
                value = data_array.coords[dim_name].values[idx]
                text = str(value)
                if text.startswith("\\") or isinstance(value, (int, float, np.number)):
                    parts.append(text)
                else:
                    parts.append(rf"\text{{{_escape_latex_text(text)}}}")
            else:
                parts.append(str(idx))
    else:
        parts = [str(i) for i in multi_idx]
    return parts


def _name_suffix(data_array, core_dim_names, multi_idx, include_coords):
    """Flattened-name suffix: coordinate-aware or index-based."""
    if include_coords and core_dim_names and len(core_dim_names) == len(multi_idx):
        parts = []
        for dim_idx, dim_name in enumerate(core_dim_names):
            if dim_name in data_array.coords:
                value = data_array.coords[dim_name].values[multi_idx[dim_idx]]
                sanitized = str(value).replace(" ", "_").replace(".", "p").replace("\\", "")
                parts.append(f"{dim_name}_{sanitized}")
            else:
                parts.append(f"{dim_name}_{multi_idx[dim_idx]}")
        return parts
    return [str(i) for i in multi_idx]


def _posterior_dims(idata):
    """(n_chains, n_draws) after validating the posterior group exists."""
    if not hasattr(idata, "posterior"):
        raise ValueError("InferenceData object must have a 'posterior' group.")
    sizes = idata.posterior.sizes
    if not {"chain", "draw"} <= set(sizes):
        raise ValueError("InferenceData posterior must have 'chain' and 'draw' dimensions.")
    return sizes["chain"], sizes["draw"]


def _per_chain_scalar(idata, var, groups, expect_shape, kind, sum_extra_dims):
    """A per-chain list of (draw,) vectors for a named scalar variable found
    in the first matching idata group; None when no variable is requested."""
    if not var:
        return None
    raw = None
    for group in groups:
        block = getattr(idata, group, None) if group in idata else None
        if block is not None and var in block:
            raw = block[var].values
            break
    if raw is None:
        places = " or ".join("idata." + g for g in groups)
        raise ValueError(f"{kind} variable '{var}' not found in {places}.")
    qualifier = ""
    if sum_extra_dims and raw.ndim > 2:
        raw = raw.sum(axis=tuple(range(2, raw.ndim)))
        qualifier = " (after sum)"
    if raw.shape != expect_shape:
        raise ValueError(f"{kind} variable '{var}'{qualifier} must have shape (chain, draw). Found {raw.shape}.")
    return list(raw)


def arviz_to_mcsamples(
    idata,
    var_names=None,
    custom_labels=None,
    custom_ranges=None,
    dataset_label=None,
    include_coords_in_name=False,
    weights_var=None,
    loglikes_var=None,
    arviz_labeller=None,
    device="cuda",
) -> MCSamples:
    """Convert an ArviZ InferenceData posterior to :class:`MCSamples`.

    :param idata: InferenceData with a 'posterior' group ('chain'/'draw' dims)
    :param var_names: variables to include (default: all posterior vars)
    :param custom_labels: name -> latex label overrides
    :param custom_ranges: name -> (min, max) hard bounds
    :param dataset_label: label shown in plot legends
    :param include_coords_in_name: use coordinate values in flattened names
    :param weights_var: variable holding per-sample weights
    :param loglikes_var: variable holding log-likelihood values
    :param arviz_labeller: optional arviz BaseLabeller for default labels
    :param device: torch device of the samples' analysis, the card unless
        the caller names the CPU (raises without CUDA)
    :return: a new :class:`MCSamples` (multi-chain structure preserved)
    """
    n_chains, n_draws = _posterior_dims(idata)
    custom_labels = custom_labels or {}
    custom_ranges = custom_ranges or {}

    names = []
    labels_map = {}
    ranges_map = {}
    target_vars = list(idata.posterior.data_vars) if var_names is None else var_names

    for var_name in target_vars:
        if var_name not in idata.posterior:
            print(f"Warning: Variable '{var_name}' not found in idata.posterior. Skipping.")
            continue
        data_array = idata.posterior[var_name]
        core_shape = data_array.shape[2:]
        if not core_shape:
            # scalar variable
            label = ""
            if arviz_labeller:
                label = arviz_labeller.make_label_flat(var_name, {}, {})
            if not label:
                label = _default_scalar_label(var_name)
            names.append(var_name)
            labels_map[var_name] = custom_labels.get(var_name, label)
            if var_name in custom_ranges:
                ranges_map[var_name] = custom_ranges[var_name]
            continue

        core_dim_names = data_array.dims[2:]
        base_label = _default_scalar_label(var_name)
        for multi_idx in np.ndindex(core_shape):
            suffix = "_".join(_name_suffix(data_array, core_dim_names, multi_idx, include_coords_in_name))
            generated = f"{var_name}_{suffix}" if suffix else var_name
            names.append(generated)

            label = ""
            if arviz_labeller:
                sel = {}
                isel = {}
                if len(core_dim_names) == len(multi_idx):
                    for dim_idx, dim_name in enumerate(core_dim_names):
                        idx = multi_idx[dim_idx]
                        isel[dim_name] = idx
                        sel[dim_name] = (
                            data_array.coords[dim_name].values[idx] if dim_name in data_array.coords else idx
                        )
                else:
                    sel = {f"dim_{d}": multi_idx[d] for d in range(len(multi_idx))}
                    isel = dict(sel)
                label = arviz_labeller.make_label_flat(var_name, sel, isel)
            if not label:
                parts = _coord_subscript(data_array, core_dim_names, multi_idx)
                label = rf"{base_label}_{{{','.join(parts)}}}" if parts else base_label
            labels_map[generated] = custom_labels.get(generated, label)
            if generated in custom_ranges:
                ranges_map[generated] = custom_ranges[generated]

    if not names:
        raise ValueError("No parameters selected or found to process after filtering and naming.")
    labels = [labels_map[name] for name in names]

    chain_arrays = []
    for c in range(n_chains):
        per_var = []
        for var_name in target_vars:
            if var_name not in idata.posterior:
                continue
            values = idata.posterior[var_name].values[c, :, ...]
            ncols = int(np.prod(values.shape[1:])) if values.shape[1:] else 1
            per_var.append(values.reshape(n_draws, ncols))
        if per_var:
            chain_arrays.append(np.concatenate(per_var, axis=1))
    if not chain_arrays and names and n_chains > 0 and n_draws > 0:
        raise ValueError("Samples array is empty, but parameter names were generated.")

    weights = _per_chain_scalar(
        idata,
        weights_var,
        ("sample_stats", "posterior"),
        (n_chains, n_draws),
        kind="Weights",
        sum_extra_dims=False,
    )
    loglikes = _per_chain_scalar(
        idata,
        loglikes_var,
        ("log_likelihood", "sample_stats"),
        (n_chains, n_draws),
        kind="LogLikes",
        sum_extra_dims=True,
    )
    if loglikes is not None:
        loglikes = [-ll for ll in loglikes]

    if n_chains == 1:
        if chain_arrays:
            chain_arrays = chain_arrays[0]
        if weights:
            weights = weights[0]
        if loglikes:
            loglikes = loglikes[0]

    return MCSamples(
        samples=chain_arrays if len(chain_arrays) else np.empty((0, len(names))),
        weights=weights,
        loglikes=loglikes,
        names=names,
        labels=labels,
        ranges=ranges_map or None,
        label=dataset_label or "MCSamples from InferenceData",
        device=device,
    )
