"""Command-line batch analysis driver (the ``getdist-tpu-torch`` console
script), the port's copy of ``getdist_tpu/command_line.py``.

Loads a chain root's chains (glob multi-root support), removes burn-in,
writes the convergence, covmat, correlation and thinned outputs, runs PCA,
computes all marginalized statistics (``.margestats`` / ``.likestats``) and
writes the plot scripts (1D / 2D / triangle / 3D; they import
``getdist_tpu_torch.plots`` and draw on the run's device), each run in a
new Python process with ``make_plots`` / ``--make_plots``. The
``MCSamples`` is built on ``device``, the
card unless the caller names the CPU (``--device cpu``): on the card its
densities are served by the fused program (``fastDensities``), on the CPU
by the host path, whose text outputs are byte-identical to the JAX
package's. ``GETDIST_TPU_TORCH_DEVICE_OPS=1`` puts the chain statistics and
the host densities' histograms and convolutions on that device too.

Structured as a small pipeline object (:class:`_BatchRun`) whose stages
mirror the analysis order; ``plot_processes`` holds the plot scripts'
processes. The GUI launchers :func:`getdist_gui` (``getdist-tpu-torch-gui``)
and :func:`getdist_streamlit` (``getdist-tpu-torch-streamlit``) start the
Qt window and the streamlit app, each with ``--device``. Nothing here
imports matplotlib or yaml (the plot scripts' processes and the GUIs do).
"""

import logging
import os
import subprocess
import sys
import time

import getdist_tpu_torch
from getdist_tpu_torch import chains
from getdist_tpu_torch.inifile import IniFile
from getdist_tpu_torch.mcsamples import MCSamples

# opts keys the reference accepts but no longer acts on
_RETIRED_KEYS = frozenset(
    (
        "make_single_samples",
        "single_thin",
        "dump_ND_bins",
        "plot_meanlikes",
        "shade_meanlikes",
        "plot_data_dir",
        "force_twotail",
    )
)


def runScript(fname):
    """Run a written plot script in a new Python process; returns its
    ``subprocess.Popen`` (the caller may wait on it)."""
    command = [sys.executable or "python", fname]
    return subprocess.Popen(command)


class _BatchRun:
    """One CLI analysis invocation: holds the option state and the captured
    output lines; stages are methods, executed in order by :meth:`execute`.
    ``stage_seconds`` holds each stage's wall, ``plot_processes`` the
    process of each plot script run (``make_plots``)."""

    def __init__(self, args, exit_on_error, device):
        self.args = args
        self.exit_on_error = exit_on_error
        self.device = device
        self.lines = []
        self.samples = None
        self.opts = None
        self.stage_seconds = {}
        self.plot_processes = []

    # -- infrastructure -----------------------------------------------------

    def fail(self, message):
        if self.exit_on_error:
            print(message)
            sys.exit()
        raise ValueError(message)

    def say(self, *items):
        self.lines.append(" ".join(str(piece) for piece in items))
        print(*items)

    def select_params(self, namestring, num=None):
        """Expand an opts parameter list (supports ?/* globs); empty means
        every parameter. With ``num``, reject lists of the wrong length."""
        chosen = []
        if not namestring.strip():
            chosen = self.samples.paramNames.list()
        else:
            for token in namestring.split():
                if "?" in token or "*" in token:
                    chosen += self.samples.paramNames.getMatches(token, strings=True)
                elif self.samples.paramNames.parWithName(token):
                    chosen.append(token)
        if num is not None and len(chosen) != num:
            self.say("%iD plot has missing parameter or wrong number of parameters: %s" % (num, chosen))
            return None
        return chosen

    # -- stages --------------------------------------------------------------

    def resolve_inputs(self):
        """Sort out the opts-file / chain-root argument forms; returns False
        when this invocation fanned out over a glob (nothing more to do)."""
        args = self.args
        self.implicit_no_plots = False
        root, settings_path = args.chain_root, args.ini_file
        if root is None:
            if settings_path is None:
                self.fail(
                    'Must give either a .ini file of parameters or a chain file root name. Run "getdist -h" for help.'
                )
            if ".ini" not in settings_path:
                # a bare chain root: analyse with packaged defaults, no plots
                root, settings_path = settings_path, getdist_tpu_torch.default_getdist_settings
                args.ini_file = settings_path
                self.implicit_no_plots = True
        if not os.path.isfile(settings_path):
            self.fail(f"Parameter file does not exist: {settings_path}")
        if root and root.endswith(".txt"):
            root = root[: -len(".txt")]

        if root is not None and any(wild in root for wild in "*?"):
            import copy
            import glob

            for suffix in (".paramnames", "updated.yaml"):
                for match in glob.glob(root + suffix):
                    sub_args = copy.copy(args)
                    sub_args.chain_root = match.replace(suffix, "")
                    getdist_script(sub_args, device=self.device)
            return False
        self.chain_root = root
        return True

    def read_settings(self):
        self.opts = opts = IniFile(self.args.ini_file)
        for key in _RETIRED_KEYS.intersection(opts.params):
            if opts.string(key) not in (0, "F"):
                logging.warning(f"{key} is no longer supported, value ignored")

        self.in_root = self.chain_root if self.chain_root is not None else opts.params["file_root"]
        if not self.in_root:
            self.fail("Chain Root file name not given ")
        self.rootname = os.path.basename(self.in_root)

        # attribute <- (typed getter, opts key, default)
        option_table = {
            "no_plots": (opts.bool, "no_plots", self.implicit_no_plots),
            "plots_only": (opts.bool, "plots_only", False),
            "plot_ext": (opts.string, "plot_ext", "py"),
            "finish_run_command": (opts.string, "finish_run_command", ""),
            "thin_factor": (opts.int, "thin_factor", 0),
            "thin_cool": (opts.float, "thin_cool", 1.0),
            "cool_factor": (opts.float, "cool", 1.0),
        }
        for attr, (getter, key, default) in option_table.items():
            setattr(self, attr, getter(key, default))
        self.chain_exclude = opts.int_list("exclude_chain")
        self.no_tests = self.plots_only or opts.bool("no_tests", False)
        self.burn_fraction = (
            self.args.ignore_rows if self.args.ignore_rows is not None else opts.float("ignore_rows", 0.0)
        )

        if "do_minimal_1d_intervals" in opts.params:
            self.fail("do_minimal_1d_intervals no longer used; set credible_interval_threshold instead")

        pca_line = opts.string("PCA_params", "")
        self.pca_params = None  # resolved after load when 'all'
        self.pca_line = pca_line
        self.pca_num = None

    def build_samples(self):
        opts = self.opts
        self.samples = samp = MCSamples(
            self.in_root,
            ini=opts,
            files_are_chains=opts.bool("samples_are_chains", True),
            paramNamesFile=opts.string("parameter_names", ""),
            device=self.device,
        )
        if any(opts.bool(key, False) for key in ("adjust_priors", "map_params")):
            self.fail(
                "To adjust priors or define new parameters, use a separate python script; "
                "see the python getdist docs for examples"
            )

        out_dir = opts.string("out_dir", default="./")
        if out_dir:
            os.path.isdir(out_dir) or os.mkdir(out_dir)
            self.say("producing files in directory ", out_dir)
        samp.out_dir = out_dir

        override_root = opts.string("out_root", "")
        if override_root:
            self.rootname = override_root
            self.say("producing files with root ", override_root)
        samp.rootname = self.rootname
        self.rootdirname = os.path.join(out_dir, self.rootname)  # output path stem
        samp.rootdirname = self.rootdirname

        if self.pca_line.lower() == "all":
            self.pca_params = samp.paramNames.list()
        else:
            self.pca_params = self.pca_line.split()
        self.pca_num = opts.int("PCA_num", len(self.pca_params))
        if self.pca_num != 0:
            if self.pca_num < 2:
                self.fail("Can only do PCA for 2 or more parameters")
            self.pca_func = opts.string("PCA_func", "") or ["N"] * self.pca_num
            self.pca_norm_param = opts.string("PCA_normparam", default="") or None

        index_filters = dict(
            first_chain=opts.int("first_chain", 0),
            last_chain=opts.int("chain_num", -1),
            chain_exclude=self.chain_exclude,
        )
        chain_files = chains.chainFiles(self.in_root, separator="_", **index_filters) or chains.chainFiles(
            self.in_root, separator=".", **index_filters
        )

        samp.loadChains(self.in_root, chain_files)
        samp.removeBurnFraction(self.burn_fraction)
        if chains.print_load_details:
            if self.burn_fraction:
                self.say("Removed %s as burn in" % self.burn_fraction)
            else:
                self.say("Removed no burn in")
        samp.deleteFixedParams()
        samp.makeSingle()

        if self.cool_factor != 1:
            self.say("Cooling chains by ", self.cool_factor)
            samp.cool(self.cool_factor)
        samp.updateBaseStatistics()

    def diagnostics(self):
        samp = self.samples
        if not self.no_tests:
            limit = samp.converge_test_limit
            samp.getConvergeTests(limit, feedback=True, writeDataToFile=True)
        samp.writeCovMatrix()
        samp.writeCorrelationMatrix()
        if self.thin_factor > 1:
            thin_ix = samp.thin_indices(self.thin_factor)
            samp.writeThinData(self.rootdirname + "_thin.txt", thin_ix, self.thin_cool)
        summary = samp.getNumSampleSummaryText()
        self.say(summary.strip())
        if samp.likeStats:
            like_text = samp.likeStats.likeSummary()
            self.say(like_text.strip())
        if self.pca_num > 0 and not self.plots_only:
            samp.PCA(self.pca_params, self.pca_func, self.pca_norm_param, writeDataToFile=True)
        samp._setDensitiesandMarge1D()

    def plot_scripts(self):
        if self.no_plots:
            return
        samp = self.samples
        opts = self.opts

        text_of = opts.string
        count_of = opts.int

        requested_1d = []
        text = text_of("plot_params", "")
        if text not in ["", "0"]:
            requested_1d = self.select_params(text)

        against_param = text_of("plot_2D_param", default="").strip()
        if not against_param or against_param == "0":
            against_param = None

        custom_pairs = []
        if not against_param:
            wanted = count_of("plot_2D_num", 0)
            for index in range(1, wanted + 1):
                pair = self.select_params(text_of(f"plot{index}"), 2)
                if pair is not None:
                    custom_pairs.append(pair)

        tri_params = []
        want_triangle = opts.bool("triangle_plot", False)
        if want_triangle:
            tri_params = self.select_params(text_of("triangle_params", ""))
            want_triangle = len(tri_params) > 1

        scatter_triples = []
        n_scatter = count_of("num_3D_plots", 0)
        for index in range(1, n_scatter + 1):
            triple = self.select_params(text_of(f"3D_plot{index}"), 3)
            if triple is not None:
                scatter_triples.append(triple)
            else:
                n_scatter -= 1

        make_now = opts.bool("make_plots", False) or self.args.make_plots

        def emit(suffix, writer, *writer_args):
            fname = self.rootdirname + suffix + "." + self.plot_ext
            writer(fname, *writer_args)
            if make_now:
                self.plot_processes.append(runScript(fname))

        emit("", samp._writeScriptPlots1D, requested_1d)

        if against_param == "corr":
            self.say("...doing 2D plots for most correlated variables")
            custom_pairs = samp.getCorrelatedVariable2DPlots()
            against_param = None
        elif against_param:
            samp.paramNames.parWithName(against_param, error=True)

        if custom_pairs or against_param:
            self.say("...producing 2D plots")
            emit("_2D", samp._writeScriptPlots2D, against_param, custom_pairs)

        if want_triangle:
            self.say("...producing triangle plot")
            emit("_tri", samp._writeScriptPlotsTri, tri_params)

        if n_scatter:
            self.say("...producing ", n_scatter, "2D colored scatter plots")
            emit("_3D", samp._writeScriptPlots3D, scatter_triples)

    def stats_outputs(self):
        samp = self.samples
        if not self.plots_only:
            samp.getMargeStats().saveAsText(self.rootdirname + ".margestats")
            if samp.loglikes is not None:
                samp.getLikeStats().saveAsText(self.rootdirname + ".likestats")
        if self.finish_run_command:
            os.system(self.finish_run_command.replace("%ROOTNAME%", self.rootname))

    def execute(self):
        if not self.resolve_inputs():
            return None
        for stage in (self.read_settings, self.build_samples, self.diagnostics, self.plot_scripts,
                      self.stats_outputs):
            start = time.perf_counter()
            stage()
            self.stage_seconds[stage.__name__] = time.perf_counter() - start
        return "\n".join(self.lines)


def getdist_script(args, exit_on_error=True, device="cuda"):
    """Run the batch analysis described by args (ini_file, chain_root,
    ignore_rows, make_plots, and optionally device) with the ``MCSamples``
    on ``device`` (``args.device`` wins where given); returns the printed
    output text."""
    device = getattr(args, "device", None) or device
    return _BatchRun(args, exit_on_error, device).execute()


def make_param_file(file_name, feedback=True):
    """Write a template distparams .ini with the analysis defaults inlined."""
    from pathlib import Path

    template = Path(getdist_tpu_torch.distparam_template).read_text(encoding="utf-8-sig")
    defaults = Path(getdist_tpu_torch.default_getdist_settings).read_text(encoding="utf-8-sig")
    filled = template.replace("%%%ANALYSIS_DEFAULTS%%%", defaults)
    Path(file_name).write_text(filled, encoding="utf-8")
    if feedback:
        print("Template .ini file written to " + file_name)


# (name, argparse options) for the console-script parser, in -h order
_CLI_ARGS = (
    ("ini_file", dict(nargs="?", help="settings .ini file (optional; packaged defaults are used if omitted)")),
    (
        "chain_root",
        dict(
            nargs="?",
            help="root name of the chain files to analyse (e.g. chains/test); "
            "needed unless the ini file sets file_root",
        ),
    ),
    (
        "--ignore_rows",
        dict(
            type=float,
            help="initial fraction of each chain to drop as burn in "
            "(or a row count if >1); takes precedence over the ini file",
        ),
    ),
    (
        "--make_param_file",
        dict(help="write an editable template distparams.ini to this path and exit"),
    ),
    ("--make_plots", dict(action="store_true", help="execute any generated plot scripts to produce PDFs")),
    ("--device", dict(default="cuda", help="torch device of the analysis: cuda (default) or cpu")),
)


def getdist_command(args=None):
    """Entry point for the ``getdist-tpu-torch`` console script."""
    import argparse

    parser = argparse.ArgumentParser(description="GetDist-TPU sample analyser, PyTorch + CUDA port")
    for name, options in _CLI_ARGS:
        parser.add_argument(name, **options)
    version_text = "%(prog)s " + getdist_tpu_torch.__version__
    parser.add_argument("--version", "-V", action="version", version=version_text)
    parsed = parser.parse_args(args)
    if parsed.make_param_file:
        make_param_file(parsed.make_param_file)
        return None
    return getdist_script(parsed)


def getdist_gui(argv=None):
    """Entry point launching the Qt desktop GUI (reference
    command_line.py:357-360): ``getdist-tpu-torch-gui [--device DEVICE]``.
    Returns 1, after printing install guidance, when PySide6 is missing."""
    import argparse

    parser = argparse.ArgumentParser(prog="getdist-tpu-torch-gui", description="GetDist-TPU GUI, PyTorch port")
    parser.add_argument("--device", default="cuda", help="torch device of the analysis: cuda (default) or cpu")
    parsed, qt_args = parser.parse_known_args(sys.argv[1:] if argv is None else argv)
    from getdist_tpu_torch.gui import mainwindow

    return mainwindow.run_gui([sys.argv[0]] + qt_args, device=parsed.device)


# launcher flags that take a value and go to the streamlit server
_SERVER_PREFIXES = ("--server.", "--browser.", "--theme.", "--logger.")


def streamlit_arguments(args):
    """(server arguments, app arguments) of ``getdist-tpu-torch-streamlit``:
    ``--port N`` / ``--port=N`` and ``--server.*`` / ``--browser.*`` /
    ``--theme.*`` / ``--logger.*`` flags (with their values) go to the
    streamlit server, everything else (the chain directory, ``--device``)
    to the app. A flag whose value is missing raises ``ValueError`` (it
    never passes an empty value on)."""
    server_args, app_args = [], []
    it = iter(args)
    for arg in it:
        if arg == "--port" or (arg.startswith(_SERVER_PREFIXES) and "=" not in arg):
            value = next(it, None)
            if value is None or value.startswith("--"):
                raise ValueError(f"{arg} needs a value")
            server_args += ["--server.port" if arg == "--port" else arg, value]
        elif arg.startswith("--port="):
            server_args += ["--server.port", arg.split("=", 1)[1]]
        elif arg.startswith(_SERVER_PREFIXES):
            server_args.append(arg)
        else:
            app_args.append(arg)
    return server_args, app_args


def getdist_streamlit(argv=None):
    """Entry point launching the streamlit web GUI:
    ``getdist-tpu-torch-streamlit [chain_dir] [--device DEVICE] [--port N]``
    (see :func:`streamlit_arguments`). Runs the server until it exits and
    returns its exit code; returns 1 after a message when streamlit is
    missing or an argument is malformed (reference
    streamlit_app.py:71-220)."""
    import importlib.util

    if importlib.util.find_spec("streamlit") is None:
        print("Please pip install streamlit first")
        return 1
    try:
        server_args, app_args = streamlit_arguments(sys.argv[1:] if argv is None else list(argv))
    except ValueError as e:
        print(f"usage: getdist-tpu-torch-streamlit [chain_dir] [--device DEVICE] [--port N]: {e}", file=sys.stderr)
        return 1
    app = os.path.join(os.path.dirname(os.path.abspath(__file__)), "gui", "streamlit_app.py")
    launch = ["streamlit", "run", app] + server_args + ["--"] + app_args
    return subprocess.Popen(launch, env=os.environ).wait()


if __name__ == "__main__":
    getdist_command()
