"""Style using matplotlib's default (tab10) color cycle."""

from matplotlib import cm

from getdist_tpu_torch import plots


class DefaultColorsPlotter(plots.GetDistPlotter):
    def set_default_settings(self):
        s = plots.GetDistPlotSettings()
        s.solid_colors = cm.tab10
        s.line_styles = cm.tab10
        s.colormap_scatter = "viridis"
        self.settings = s


style_name = "tab10"
plots.add_plotter_style(style_name, DefaultColorsPlotter)
