"""The port's batch command (``getdist_tpu_torch.command_line``) against the
JAX package's (``getdist_tpu.command_line``).

On a chain root written with ``tests/fixtures/realchain.py`` (4 chains of
12000 rows, 27 parameters, ``.ranges``) and one ini (PCA of four
parameters with L maps, ``thin_factor`` 10, plot scripts written: 1D, the
most correlated 2D pairs, a triangle and a 3D plot), the port's
``getdist_script(..., device="cpu")`` and the JAX package's
``getdist_script`` (x64 off: its numpy statistics) each write into a
directory of their own. Held: every text output byte-identical
(``.margestats``, ``.likestats``, ``.converge``, ``.covmat``, ``.corr``,
``.PCA``, ``_thin.txt``) and the printed lines equal; the plot scripts
equal up to the package name, the plotter's ``device='cpu'`` and output
directory; ``--make_plots`` (and ``make_plots`` in the ini) running the
scripts to the same figure files as the JAX command's; ``--version``;
``make_param_file``; the bare-root run with the packaged defaults;
``--device``; and a fresh process running the command imports neither
JAX, ``getdist_tpu``, matplotlib nor yaml.
"""

import contextlib
import os
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

from torch_cpu_threads import torch_threads_per_worker  # noqa: E402,F401 (module fixture)

import getdist_tpu_torch  # noqa: E402
import jax  # noqa: E402
from fixtures import realchain  # noqa: E402
from getdist_tpu import chains as jchains  # noqa: E402
from getdist_tpu import command_line as jcl  # noqa: E402
from getdist_tpu_torch import chains as tchains  # noqa: E402
from getdist_tpu_torch import command_line as tcl  # noqa: E402
from getdist_tpu_torch.inifile import IniFile  # noqa: E402

RANGES = "tau 0.01 N\nxi 0 1 periodic\naksz 0 N\n"
TEXT_OUTPUTS = (".margestats", ".likestats", ".converge", ".covmat", ".corr", ".PCA", "_thin.txt")
SCRIPTS = ("", "_2D", "_tri", "_3D")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = realchain.generate(tmp_path_factory.mktemp("cli_chains"))
    with open(root + ".ranges", "w", encoding="utf-8") as handle:
        handle.write(RANGES)
    return root


@pytest.fixture(scope="module")
def quiet():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tchains, "print_load_details", False)
        mp.setattr(jchains, "print_load_details", False)
        for name in ("GETDIST_TPU_TORCH_FUSED", "GETDIST_TPU_FUSED", "GETDIST_TPU_TORCH_DEVICE_OPS"):
            mp.delenv(name, raising=False)
        yield mp


def write_ini(module, path, root, out_dir, **extra):
    module.make_param_file(str(path), feedback=False)
    ini = IniFile(str(path))
    ini.params.update({
        "file_root": root, "out_dir": str(out_dir), "PCA_num": "4", "PCA_params": "omegabh2 omegach2 theta logA",
        "PCA_func": "LLLN", "PCA_normparam": "omegach2", "thin_factor": "10", "no_plots": "F",
        "plot_params": "omegabh2 tau xi", "plot_2D_param": "corr", "triangle_plot": "T",
        "triangle_params": "omegabh2 omegach2 tau", "num_3D_plots": "1", "3D_plot1": "omegabh2 omegach2 tau",
    })
    ini.params.update(extra)
    ini.saveFile(str(path))
    return str(path)


def args_for(ini_file, root=None, **kw):
    return types.SimpleNamespace(ini_file=ini_file, chain_root=root, ignore_rows=None, make_plots=False, **kw)


def run(which, args, **kw):
    """One CLI run of the port (device cpu) or the JAX package (x64 off)."""
    if which == "port":
        return tcl.getdist_script(args, exit_on_error=False, device="cpu", **kw)
    with jax.enable_x64(False):
        return jcl.getdist_script(args, exit_on_error=False)


@pytest.fixture(scope="module")
def runs(root, quiet, tmp_path_factory):
    """{which: (folder, printed text)} for the port and the JAX package."""
    out = {}
    for which, module in (("port", tcl), ("jax", jcl)):
        folder = tmp_path_factory.mktemp(f"cli_{which}")
        ini = write_ini(module, folder / "pars.ini", root, folder)
        out[which] = (folder, run(which, args_for(ini, root)))
    return out


@pytest.mark.parametrize("suffix", TEXT_OUTPUTS)
def test_text_outputs_byte_identical(runs, suffix):
    got, want = ((runs[w][0] / ("planck_like" + suffix)).read_bytes() for w in ("port", "jax"))
    assert got == want and got


def test_printed_lines_equal(runs):
    port_text = runs["port"][1].replace(str(runs["port"][0]), "OUT")
    assert port_text == runs["jax"][1].replace(str(runs["jax"][0]), "OUT")
    assert "-Ln(mean like)" in port_text and "...producing triangle plot" in port_text


@pytest.mark.parametrize("suffix", SCRIPTS)
def test_plot_scripts_equal_up_to_package(runs, suffix):
    got = (runs["port"][0] / f"planck_like{suffix}.py").read_text()
    want = (runs["jax"][0] / f"planck_like{suffix}.py").read_text()
    assert got.startswith("import getdist_tpu_torch.plots as plots, os\n")
    assert "device='cpu')\n" in got
    normalized = got.replace("getdist_tpu_torch.plots", "getdist_tpu.plots").replace(str(runs["port"][0]), "OUT")
    normalized = normalized.replace(", device='cpu')\n", ")\n")
    assert normalized == want.replace(str(runs["jax"][0]), "OUT")


@pytest.mark.parametrize("where", ["flag", "ini"])
def test_make_plots_runs_scripts(root, quiet, tmp_path, monkeypatch, where):
    """``--make_plots`` (or ``make_plots`` in the ini): the port's command
    (``--device cpu``) runs each plot script it writes in a new process
    (``_BatchRun.plot_processes``), which draws on the CPU, and the figure
    files are those of the JAX command's scripts."""
    monkeypatch.setenv("MPLBACKEND", "Agg")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setenv("PYTHONPATH", REPO)
    procs, figures = {"port": [], "jax": []}, {}
    monkeypatch.setattr(jcl, "subprocess", types.SimpleNamespace(
        Popen=lambda command: procs["jax"].append(subprocess.Popen(command))))
    for which, module in (("port", tcl), ("jax", jcl)):
        folder = tmp_path / which
        folder.mkdir()
        ini = write_ini(module, folder / "pars.ini", root, folder, **({"make_plots": "T"} if where == "ini" else {}))
        args = args_for(ini, root)
        args.make_plots = where == "flag"
        if which == "port":
            batch = tcl._BatchRun(args, False, "cpu")
            batch.execute()
            procs["port"] = batch.plot_processes
        else:
            run(which, args)
    for which, started in procs.items():
        assert len(started) == len(SCRIPTS) and all(isinstance(p, subprocess.Popen) for p in started)
        assert [p.wait(timeout=600) for p in started] == [0] * len(SCRIPTS), which
        figures[which] = sorted(name for name in os.listdir(tmp_path / which) if name.endswith(".pdf"))
    assert figures["port"] == figures["jax"] == sorted(f"planck_like{s}.pdf" for s in SCRIPTS)
    assert all((tmp_path / "port" / name).stat().st_size > 2000 for name in figures["port"])


def test_version_flag(capsys):
    with pytest.raises(SystemExit):
        tcl.getdist_command(["--version"])
    assert getdist_tpu_torch.__version__ in capsys.readouterr().out


def test_make_param_file_matches_jax(tmp_path):
    tcl.make_param_file(str(tmp_path / "port.ini"), feedback=False)
    jcl.make_param_file(str(tmp_path / "jax.ini"), feedback=False)
    assert (tmp_path / "port.ini").read_bytes() == (tmp_path / "jax.ini").read_bytes()
    assert "%%%ANALYSIS_DEFAULTS%%%" not in (tmp_path / "port.ini").read_text()


def test_bare_root_default_run(root, quiet, tmp_path):
    """A chain root alone: the packaged defaults, outputs in the working
    directory, no plot scripts, the same bytes as the JAX package's."""
    files = {}
    for which in ("port", "jax"):
        folder = tmp_path / which
        folder.mkdir()
        with contextlib.chdir(folder):
            run(which, args_for(root))
        files[which] = {name: (folder / name).read_bytes() for name in sorted(os.listdir(folder))}
    assert sorted(files["port"]) == ["planck_like" + s for s in (".converge", ".corr", ".covmat", ".likestats",
                                                                  ".margestats")]
    assert files["port"] == files["jax"]


def test_console_script_device_flag(root, quiet, tmp_path):
    with contextlib.chdir(tmp_path):
        tcl.getdist_command([root, "--device", "cpu"])
    assert (tmp_path / "planck_like.margestats").exists()
    if not torch.cuda.is_available():
        with contextlib.chdir(tmp_path), pytest.raises(RuntimeError, match="CUDA is not available"):
            tcl.getdist_command([root])


def test_command_imports_no_jax_matplotlib_or_yaml(root, tmp_path):
    code = (
        "import sys, runpy\n"
        f"sys.argv = ['getdist-tpu-torch', {root!r}, '--device', 'cpu']\n"
        "runpy.run_module('getdist_tpu_torch.command_line', run_name='__main__')\n"
        "bad = [m for m in ('jax', 'getdist_tpu', 'matplotlib', 'yaml') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("GETDIST_TPU_TORCH_DEVICE_OPS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=tmp_path, env=env,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
    assert (tmp_path / "planck_like.margestats").exists()
