"""Reproducible plot-script generation shared by the GUIs.

The port's own copy of ``getdist_tpu/gui/plot_script.py``. The reference
GUI's defining behavior (``gui/mainwindow.py:1637-1760``) is that every
plot the user configures is first rendered to a runnable python script,
which is both executed for the preview and exportable. These helpers build
those scripts; they are plain functions so they are testable without any
GUI toolkit installed. A script imports ``getdist_tpu_torch.plots`` and
names its plotter's torch ``device`` (``device='cpu'`` in a CPU session's
script, as the batch command's plot scripts do). A style module
(``plot_module``, e.g. ``getdist_tpu_torch.styles.planck``) is imported and
activated by its ``style_name`` (ROADMAP C22).
"""

__all__ = ["generate_plot_script", "script_exec_globals"]


def _root_expr(root):
    return repr(root)


def generate_plot_script(
    roots,
    params,
    plot_type="1d",
    chain_dir=None,
    filled=True,
    shaded=False,
    normalized=False,
    color_param=None,
    y_params=None,
    subplot_size=2.5,
    width_inch=None,
    analysis_settings=None,
    plot_module=None,
    plot_settings=None,
    export_name=None,
    device="cuda",
):
    """Build a runnable plot script for the given configuration.

    :param roots: list of root name strings
    :param params: list of parameter names (x[, y[, color]])
    :param plot_type: '1d' | '2d_filled' | '2d_line' | 'triangle' | '3d' | '1d_grid'
    :param chain_dir: directory used to resolve roots
    :param filled: filled contours for 2D/triangle
    :param shaded: shaded 2D density
    :param color_param: color parameter for 3d scatter
    :param subplot_size: subplot size in inches
    :param width_inch: fixed total width (single plots)
    :param analysis_settings: dict of analysis-setting overrides
    :param export_name: output filename for g.export
    :param device: torch device the script's plotter loads the roots on
    :return: the script text
    """
    lines = ["import getdist_tpu_torch.plots as gplots", ""]
    if plot_module:
        # importing a style module registers its style under style_name
        lines.insert(1, "import %s" % plot_module)
        lines.append("gplots.set_active_style(%s.style_name)" % plot_module)
    kwargs = []
    if chain_dir:
        kwargs.append("chain_dir=%r" % chain_dir)
    if analysis_settings:
        kwargs.append("analysis_settings=%r" % dict(analysis_settings))
    if plot_type in ("1d", "2d_filled", "2d_line", "3d"):
        maker = "get_single_plotter"
        if width_inch:
            kwargs.append("width_inch=%r" % width_inch)
    else:
        maker = "get_subplot_plotter"
        kwargs.append("subplot_size=%r" % subplot_size)
    kwargs.append("device=%r" % str(device))
    lines.append("g = gplots.%s(%s)" % (maker, ", ".join(kwargs)))
    for key, value in (plot_settings or {}).items():
        lines.append("g.settings.%s = %r" % (key, value))
    lines.append("roots = [%s]" % ", ".join(_root_expr(r) for r in roots))

    if plot_type == "1d":
        lines.append("g.plot_1d(roots, %r, normalized=%r)" % (params[0], normalized))
    elif plot_type == "1d_grid":
        lines.append("g.plots_1d(roots, params=%r)" % (list(params),))
    elif plot_type == "rectangle":
        lines.append(
            "g.rectangle_plot(%r, %r, roots=roots, filled=%r)" % (list(params), list(y_params or []), filled)
        )
    elif plot_type in ("2d_filled", "2d_line"):
        lines.append(
            "g.plot_2d(roots, %r, %r, filled=%r, shaded=%r)"
            % (params[0], params[1], plot_type == "2d_filled", shaded)
        )
    elif plot_type == "triangle":
        lines.append("g.triangle_plot(roots, %r, filled=%r, shaded=%r)" % (list(params), filled, shaded))
    elif plot_type == "3d":
        color = color_param or (params[2] if len(params) > 2 else params[0])
        lines.append("g.plot_3d(roots, [%r, %r, %r])" % (params[0], params[1], color))
    else:
        raise ValueError("unknown plot_type %r" % plot_type)
    if export_name:
        lines.append("g.export(%r)" % export_name)
    return "\n".join(lines) + "\n"


def script_exec_globals(extra_roots=None):
    """Globals dict for exec'ing a generated script in-process; in-memory
    MCSamples roots can be injected via extra_roots {name: samples}."""
    import getdist_tpu_torch.plots as gplots

    env = {"gplots": gplots}
    if extra_roots:
        env.update(extra_roots)
    return env
