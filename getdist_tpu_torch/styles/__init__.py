"""Named plotter styles. Importing a style module registers it with
getdist_tpu_torch.plots.add_plotter_style."""
