"""Streamlit web GUI for browsing chains and making plots.

The port's own copy of ``getdist_tpu/gui/streamlit_app.py``. Web
re-implementation of the reference GUI capabilities (reference
``getdist/gui/streamlit_app.py`` / ``mainwindow.py``): open chain
directories and grid hierarchies (with recent-directories memory and
param-tag browsing), manage an ordered multi-root selection, build
1D/grid/2D/triangle/rectangle/3D plots with the reference's plot options,
view marginalized/likelihood/convergence/PCA statistics and LaTeX parameter
tables, edit the full analysis-settings schema, switch plot style modules,
and preview/download the reproducible plot script behind every figure.

All state and logic live in :mod:`getdist_tpu_torch.gui.app_logic`
(testable without streamlit); this module is the rendering layer only.
The session runs on the torch device the app's arguments name (``--device
cpu``; the card by default, as ``getdist-tpu-torch --device`` does). The
LaTeX table's tabs are keyed by limit index (two limits with the same
rounded label would give streamlit a duplicate widget key: ROADMAP C5).

Run with: ``getdist-tpu-torch-streamlit [chain_dir] [--device cpu]`` or
``streamlit run getdist_tpu_torch/gui/streamlit_app.py -- [chain_dir] [--device cpu]``.
"""

import io
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from getdist_tpu_torch.gui.app_logic import (
    PLOT_TYPES,
    GuiSession,
    PlotSpec,
    analysis_settings_schema,
    load_recent_dirs,
    parse_plot_setting,
    plot_settings_schema,
)

STYLE_MODULES = {
    "default": None,
    "planck": "getdist_tpu_torch.styles.planck",
    "tab10": "getdist_tpu_torch.styles.tab10",
}

STATS_VIEWS = ("Marginalized stats", "Likelihood stats", "Convergence", "PCA", "LaTeX table")


def app_arguments(argv=None):
    """(chain directory or None, device) from the app's arguments:
    ``[chain_dir] [--device DEVICE]`` (default device ``cuda``; other
    arguments are left to streamlit)."""
    import argparse

    parser = argparse.ArgumentParser(prog="getdist-tpu-torch-streamlit")
    parser.add_argument("chain_dir", nargs="?")
    parser.add_argument("--device", default="cuda", help="torch device of the analysis: cuda (default) or cpu")
    parsed, _ = parser.parse_known_args(sys.argv[1:] if argv is None else argv)
    chain_dir = parsed.chain_dir if parsed.chain_dir and os.path.isdir(parsed.chain_dir) else None
    return chain_dir, parsed.device


def _session(state, device):
    """The GuiSession stored in streamlit session state."""
    if "gui_session" not in state:
        state["gui_session"] = GuiSession(device=device)
    return state["gui_session"]


def _sidebar_directory(st, state, session, args_dir):
    """Directory/grid opening controls; returns the root list."""
    st.header("Chains")
    recents = load_recent_dirs()
    default_dir = session.chain_dir or args_dir or (recents[0] if recents else "")
    chain_dir = st.text_input("Chain directory or grid path", value=default_dir)
    if recents:
        chosen = st.selectbox("Recent directories", ["(keep current)"] + recents)
        if chosen != "(keep current)":
            chain_dir = chosen
    open_now = st.button("Open directory", use_container_width=True)
    if open_now or (chain_dir and chain_dir != session.chain_dir and os.path.isdir(chain_dir)):
        try:
            session.open_directory(chain_dir)
        except FileNotFoundError:
            st.error(f"Directory not found: {chain_dir}")
    if st.button("Re-load files", use_container_width=True, disabled=not session.chain_dir):
        session.reload_files()

    if not session.chain_dir:
        return []
    if session.is_grid():
        st.caption(f"Grid: {session.chain_dir}")
        tag = st.selectbox("Parameter tag", ["(all)"] + session.param_tags())
        if tag == "(all)":
            return session.available_roots()
        # second browsing level: data-combination tag (reference
        # setParamTag/setDataTag grid navigation)
        datatag = st.selectbox("Data tag", ["(all data)"] + session.data_tags(tag))
        return session.roots_for_tag(tag, None if datatag == "(all data)" else datatag)
    return session.available_roots()


def _sidebar_roots(st, session, roots):
    """Ordered multi-root selection with reordering buttons."""
    picked = st.multiselect("Roots", roots, default=[r for r in session.root_order if r in roots])
    session.set_roots(picked)
    if len(session.root_order) > 1:
        with st.expander("Order roots"):
            for root in list(session.root_order):
                cols = st.columns([4, 1, 1])
                cols[0].write(root)
                if cols[1].button("up", key=f"up_{root}"):
                    session.move_root(root, -1)
                    st.rerun()
                if cols[2].button("down", key=f"down_{root}"):
                    session.move_root(root, +1)
                    st.rerun()
    return session.root_order


def _sidebar_settings(st, state, session):
    """Full analysis-settings form (schema from analysis_defaults.ini),
    plot style module picker, and reset."""
    st.header("Options")
    with st.expander("Analysis settings"):
        overrides = {}
        for fieldspec in analysis_settings_schema():
            current = session.analysis_settings.get(fieldspec.name, fieldspec.default)
            key = f"set_{fieldspec.name}"
            if fieldspec.type is bool:
                value = st.checkbox(fieldspec.name, value=bool(current), key=key, help=fieldspec.help or None)
            elif fieldspec.type is int:
                value = st.number_input(
                    fieldspec.name, value=int(current), step=1, key=key, help=fieldspec.help or None
                )
            elif fieldspec.type is float:
                value = st.number_input(
                    fieldspec.name, value=float(current), format="%.5g", key=key, help=fieldspec.help or None
                )
            else:
                value = st.text_input(fieldspec.name, value=str(current), key=key, help=fieldspec.help or None)
            if value != fieldspec.default:
                overrides[fieldspec.name] = value
        col_a, col_b = st.columns(2)
        if col_a.button("Apply settings"):
            session.apply_analysis_settings(overrides)
            st.rerun()
        if col_b.button("Reset defaults"):
            session.reset_analysis_settings()
            st.rerun()
    with st.expander("Plot settings (style)"):
        # full GetDistPlotSettings schema, as the reference's plot-settings
        # dialog exposes (mainwindow.py:993-1058); string fields accept
        # python literals (lists/dicts/None) or bare words
        overrides = {}
        errors = []
        for fieldspec in plot_settings_schema():
            applied = session.custom_plot_settings.get(fieldspec.name, fieldspec.default)
            key = f"ps_{fieldspec.name}"
            if fieldspec.type is bool:
                value = st.checkbox(fieldspec.name, value=bool(applied), key=key)
            elif fieldspec.type is int:
                value = st.number_input(fieldspec.name, value=int(applied), step=1, key=key)
            elif fieldspec.type is float:
                value = st.number_input(fieldspec.name, value=float(applied), format="%.5g", key=key)
            else:
                value = st.text_input(fieldspec.name, value=str(applied), key=key)
            if value != fieldspec.default:
                try:
                    overrides[fieldspec.name] = parse_plot_setting(fieldspec, str(value))
                except Exception as e:
                    errors.append(f"{fieldspec.name}: {e}")
        if errors:
            st.error("; ".join(errors))
        col_c, col_d = st.columns(2)
        if col_c.button("Apply plot settings"):
            session.apply_plot_settings(overrides)
            st.rerun()
        if col_d.button("Reset plot settings"):
            session.reset_plot_settings()
            st.rerun()
    style = st.selectbox("Plot style module", list(STYLE_MODULES), index=0)
    if STYLE_MODULES[style] != session.plot_module:
        session.set_plot_module(STYLE_MODULES[style])
    changed = session.changed_settings()
    if changed:
        # non-default option summary (reference changed_settings display)
        parts = []
        if "analysis" in changed:
            parts.append(f"{len(changed['analysis'])} analysis")
        if "plot" in changed:
            parts.append(f"{len(changed['plot'])} plot")
        if "style" in changed:
            parts.append(f"style={changed['style'].rsplit('.', 1)[-1]}")
        st.caption("Changed settings: " + ", ".join(parts))


def _plot_controls(st, state, params):
    """Plot-spec form; returns a PlotSpec."""
    c1, c2, c3 = st.columns(3)
    with c1:
        plot_type = st.selectbox("Plot type", list(PLOT_TYPES), index=0)
    with c2:
        x_params = st.multiselect("X parameters", params, default=params[: min(3, len(params))])
    with c3:
        y_params = st.multiselect("Y parameters (rectangle)", params)

    o1, o2, o3, o4, o5, o6 = st.columns(6)
    filled = o1.checkbox("Filled", value=True)
    shaded = o2.checkbox("Shaded", value=False)
    normalized = o3.checkbox("Normalized", value=False)
    color_param = o4.selectbox("Color param (3d)", ["(none)"] + params)
    subplot_size = o5.number_input("Subplot size (inch)", value=2.5, min_value=1.0, max_value=8.0)
    # overall figure width: the reference's size-for-N control
    # (streamlit_app.py set_size_for_n); 0 = derive from subplot size
    width_inch = o6.number_input("Figure width (inch, 0=auto)", value=0.0, min_value=0.0, max_value=30.0)
    plot_settings = {}
    with st.expander("Plot options"):
        for key, default, step in (
            ("num_plot_contours", 2, 1),
            ("axes_fontsize", 0, 1),
            ("legend_fontsize", 0, 1),
            ("linewidth", 0.0, 0.25),
            ("alpha_filled_add", 0.0, 0.05),
        ):
            value = st.number_input(key, value=default, step=step, key=f"po_{key}")
            if value != default:
                plot_settings[key] = value
        solid = st.checkbox("solid_contour_palefactor default", value=True, key="po_solid")
        if not solid:
            plot_settings["solid_contour_palefactor"] = st.number_input(
                "solid_contour_palefactor", value=0.6, key="po_palefactor"
            )
    return PlotSpec(
        plot_type=plot_type,
        x_params=x_params,
        y_params=y_params,
        color_param=None if color_param == "(none)" else color_param,
        filled=filled,
        shaded=shaded,
        normalized=normalized,
        subplot_size=float(subplot_size),
        width_inch=float(width_inch) or None,
        plot_settings=plot_settings,
    )


def _render_plot_tab(st, state, session, params):
    spec = _plot_controls(st, state, params)
    issues = spec.problems()
    if issues:
        st.warning("; ".join(issues))
        return
    script = session.script_for(spec)
    if st.button("Make plot", type="primary"):
        try:
            fig, script = session.make_figure(spec)
        except Exception as e:  # surface plotting errors in the UI
            st.error(f"Plot failed: {e}")
            return
        state["current_fig"] = fig
    fig = state.get("current_fig")
    if fig is not None:
        st.pyplot(fig)
        png = io.BytesIO()
        fig.savefig(png, format="png", dpi=150, bbox_inches="tight")
        pdf = io.BytesIO()
        fig.savefig(pdf, format="pdf", bbox_inches="tight")
        svg = io.BytesIO()
        fig.savefig(svg, format="svg", bbox_inches="tight")
        d1, d2, d3 = st.columns(3)
        d1.download_button("Download PNG", png.getvalue(), "getdist_plot.png", "image/png")
        d2.download_button("Download PDF", pdf.getvalue(), "getdist_plot.pdf", "application/pdf")
        d3.download_button("Download SVG", svg.getvalue(), "getdist_plot.svg", "image/svg+xml")
    with st.expander("Plot script (editable, reproducible)", expanded=fig is None):
        # the edited text is re-executed for the preview — the reference
        # GUI's script-tab workflow (mainwindow.py plotData2)
        edited = st.text_area("Script", value=state.get("script_text", script), height=320, key="script_area")
        state["script_text"] = edited
        e1, e2, e3 = st.columns(3)
        if e1.button("Run edited script"):
            try:
                state["current_fig"] = session.run_script(edited)
                st.rerun()
            except Exception as e:
                st.error(f"Script failed: {e}")
        if e2.button("Regenerate from controls"):
            state["script_text"] = script
            st.rerun()
        e3.download_button("Download script", edited, "plot_script.py", "text/x-python")


def _render_stats_tab(st, state, session, params):
    multi = len(session.root_order) > 1
    root_pick = ["(compare all roots)"] + session.root_order if multi else session.root_order
    root = st.selectbox("Root", root_pick)
    which = st.radio("View", list(STATS_VIEWS), horizontal=True)
    if root == "(compare all roots)":
        # side-by-side stats for the whole selection (the reference
        # streamlit app's multi-root stats views, streamlit_app.py:499-664)
        columns = st.columns(len(session.root_order))
        for col, one in zip(columns, session.root_order):
            with col:
                st.caption(one)
                try:
                    if which == "Marginalized stats":
                        st.text(session.marge_stats(one))
                    elif which == "Likelihood stats":
                        st.text(session.like_stats(one))
                    elif which == "Convergence":
                        st.text(session.converge_stats(one))
                    else:
                        st.info("Pick a single root for PCA / tables.")
                        break
                except Exception as e:
                    st.error(f"{one}: {e}")
        return
    try:
        if which == "Marginalized stats":
            st.text(session.marge_stats(root))
        elif which == "Likelihood stats":
            st.text(session.like_stats(root))
        elif which == "Convergence":
            st.text(session.converge_stats(root))
        elif which == "PCA":
            pca_params = st.multiselect("PCA parameters", params, default=params[:2], key="pca_params")
            if len(pca_params) >= 2:
                st.text(session.pca_report(root, pca_params))
            else:
                st.info("Pick two or more parameters for PCA.")
        else:
            table_params = st.multiselect("Table parameters (all if empty)", params, key="table_params")
            # one tab per confidence limit (the reference's parameter-table
            # dialog layout), each downloadable as .tex; keyed by limit
            # index, since two limits may round to the same label
            tabs = session.param_table_tabs(root, table_params or None)
            for i, (tab, (label, tex)) in enumerate(zip(st.tabs([label for label, _ in tabs]), tabs)):
                with tab:
                    st.code(tex, language="latex")
                    st.download_button(
                        f"Download {label} table (.tex)",
                        tex,
                        f"{root}_limit{i + 1}.tex",
                        "text/x-tex",
                        key=f"textab_{i}",
                    )
    except Exception as e:
        st.error(f"Statistics failed: {e}")


def main(argv=None):
    import matplotlib

    matplotlib.use("Agg")
    import streamlit as st

    args_dir, device = app_arguments(argv)
    st.set_page_config(page_title="GetDist-TPU GUI (PyTorch)", layout="wide")
    st.title("GetDist-TPU sample analyser (PyTorch)")

    state = st.session_state
    session = _session(state, device)

    with st.sidebar:
        roots = _sidebar_directory(st, state, session, args_dir)
        selected = _sidebar_roots(st, session, roots) if roots else []
        _sidebar_settings(st, state, session)

    if not session.chain_dir:
        st.info("Open a chain directory (or grid path) to begin.")
        return
    if not selected:
        st.info("Select one or more chain roots in the sidebar.")
        return

    params = session.param_list()
    plot_tab, stats_tab, about_tab = st.tabs(["Plots", "Statistics", "About"])
    with plot_tab:
        _render_plot_tab(st, state, session, params)
    with stats_tab:
        _render_stats_tab(st, state, session, params)
    with about_tab:
        import getdist_tpu_torch

        st.markdown(
            f"**GetDist-TPU, PyTorch port** {getdist_tpu_torch.__version__} — MCMC sample analysis "
            f"on {session.device}.\n\n"
            "Every plot is generated from a reproducible python script (see the "
            "Plots tab) that can be run outside the GUI."
        )


if __name__ == "__main__":
    main()
