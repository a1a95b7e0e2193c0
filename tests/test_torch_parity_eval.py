"""The port's weights-parity harness (horizonnet_tpu_torch/tools/
parity_eval.py) against the JAX package's (tools/parity_eval.py), on the
CPU with the committed golden checkpoint and fixture room.

Both harnesses run once each in general mode (module fixtures), the port's
with ``--device cpu``. Bars:
- on the same dt/*.json, the port's eval_general_metrics and
  eval_cuboid_metrics equal JAX's to the bit (the eval numpy is a copy);
- end to end each metric lies within 1e-3 points of JAX's harness (the
  two forwards differ by at most 2e-4);
- the verdicts, the report table, the exit codes 0 / 1 / 2, the presets
  and tolerances, --expect/--tol parsing and --root_dir's parser error
  are JAX's;
- with --need_preprocess the aligned pano is byte for byte what the
  port's preprocess CLI writes with --rgbonly --device cpu, and the tool
  imports neither jax nor horizonnet_tpu (checked in a fresh process).
"""

import contextlib
import glob
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from horizonnet_tpu_torch.cli import preprocess
from horizonnet_tpu_torch.preprocess.host_resample import \
    rotate_panorama_uint8_host
from horizonnet_tpu_torch.utils.image import read_png, write_png
from tests.test_evals import _synthetic_cuboid
from tests.test_torch_preprocess import yaw_tilt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(ROOT, "tests", "fixtures", "golden")
CKPT = os.path.join(FIXDIR, "resnet18_rnn_synth.ckpt")
PORT_TOOL = os.path.join(ROOT, "horizonnet_tpu_torch", "tools",
                         "parity_eval.py")
JAX_TOOL = os.path.join(ROOT, "tools", "parity_eval.py")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return (_load(PORT_TOOL, "torch_parity_eval"),
            _load(JAX_TOOL, "jax_parity_eval"))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """img/val_room.png with label_cor/val_room.txt (its 12-corner label),
    and label_box/val_room.txt, an 8-corner box for the cuboid metrics
    (test_cuboid stops on the 12-corner label)."""
    root = tmp_path_factory.mktemp("ds")
    for d in ("img", "label_cor", "label_box"):
        os.makedirs(root / d)
    shutil.copy(os.path.join(FIXDIR, "val_room.png"),
                root / "img" / "val_room.png")
    shutil.copy(os.path.join(FIXDIR, "val_room_cor.txt"),
                root / "label_cor" / "val_room.txt")
    np.savetxt(root / "label_box" / "val_room.txt",
               _synthetic_cuboid(dx=0.3, dy=-0.2), fmt="%.4f")
    return root


def _argv(root, out, mode, *extra):
    return ["--pth", CKPT, "--root_dir", str(root), "--dataset", "custom",
            "--mode", mode, "--output_dir", str(out), "--batch_size", "1",
            *extra]


@pytest.fixture(scope="module")
def runs(tools, dataset, tmp_path_factory):
    """One general-mode harness run of each package: {name: (rc, out)}."""
    port, jax_tool = tools
    out = {}
    for name, tool, extra in (("port", port, ["--device", "cpu"]),
                              ("jax", jax_tool, [])):
        d = tmp_path_factory.mktemp(f"out_{name}")
        out[name] = (tool.main(_argv(dataset, d, "general", *extra)), d)
    return out


@pytest.fixture(scope="module")
def cuboid_run(tools, dataset, tmp_path_factory):
    """The port's harness in cuboid mode against the 8-corner box."""
    d = tmp_path_factory.mktemp("out_cuboid")
    rc = tools[0].main(["--pth", CKPT, "--img_glob",
                        str(dataset / "img" / "*"), "--gt_glob",
                        str(dataset / "label_box" / "*txt"), "--mode",
                        "cuboid", "--output_dir", str(d), "--batch_size",
                        "1", "--device", "cpu"])
    return rc, d


def _general(tool, root, out):
    with contextlib.redirect_stderr(io.StringIO()):
        return tool.eval_general_metrics(str(root / "label_cor" / "*txt"),
                                         str(out / "dt" / "*.json"), 1024,
                                         512)


def test_harness_runs_and_writes_outputs(runs):
    rc, out = runs["port"]
    assert rc == 0 == runs["jax"][0]   # no expectations -> informational
    jsons = glob.glob(str(out / "dt" / "*.json"))
    assert len(jsons) == 1
    with open(jsons[0]) as f:
        dt = json.load(f)
    assert len(dt["uv"]) >= 8 and len(dt["uv"]) % 2 == 0
    assert np.isfinite(dt["z1"])


@pytest.mark.parametrize("dt_of", ["port", "jax"])
def test_general_metrics_equal_jax_on_same_jsons(tools, dataset, runs,
                                                 dt_of):
    port, jax_tool = tools
    out = runs[dt_of][1]
    metrics, n = _general(port, dataset, out)
    assert (metrics, n) == _general(jax_tool, dataset, out)
    assert n == 1 and set(metrics) == {"2DIoU", "3DIoU", "rmse", "delta_1"}
    assert 0 < metrics["3DIoU"] <= 100


def test_end_to_end_within_1e3_of_jax(tools, dataset, runs):
    got, _ = _general(tools[0], dataset, runs["port"][1])
    want, _ = _general(tools[1], dataset, runs["jax"][1])
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])


def test_cuboid_metrics_equal_jax_on_same_jsons(tools, dataset, cuboid_run):
    rc, out = cuboid_run
    assert rc == 0
    args = (str(dataset / "label_box" / "*txt"), str(out / "dt" / "*.json"),
            1024, 512)
    metrics, n = tools[0].eval_cuboid_metrics(*args)
    assert (metrics, n) == tools[1].eval_cuboid_metrics(*args)
    assert n == 1 and set(metrics) == {"CE", "PE", "3DIoU"}
    assert 0 < metrics["3DIoU"] < 100 and np.isfinite(list(metrics.values())
                                                      ).all()


@pytest.mark.parametrize("shift,want", [(0.0, []), (50.0, ["3DIoU"])])
def test_report_verdicts_and_table_equal_jax(tools, dataset, runs, shift,
                                             want):
    metrics, n = _general(tools[0], dataset, runs["port"][1])
    expect, tol = {"3DIoU": metrics["3DIoU"] + shift}, {"3DIoU": 1.0}
    texts = []
    for tool in tools:
        s = io.StringIO()
        assert tool.report("custom", "general", n, metrics, expect, tol,
                           stream=s) == want
        texts.append(s.getvalue())
    assert texts[0] == texts[1]


@pytest.mark.parametrize("shift,tol,rc", [(50.0, ["--tol", "3DIoU=0.5"], 2),
                                          (0.0, [], 0)])
def test_expect_and_tol_drive_the_exit_code(tools, dataset, runs, tmp_path,
                                            capsys, shift, tol, rc):
    metrics, _ = _general(tools[0], dataset, runs["port"][1])
    got = tools[0].main(_argv(dataset, tmp_path, "general", "--device",
                              "cpu", "--expect",
                              "3DIoU=%.2f" % (metrics["3DIoU"] + shift),
                              *tol))
    assert got == rc
    out, err = capsys.readouterr()
    if rc == 0:
        assert out.rstrip().endswith("PARITY OK")
    else:
        assert "PARITY FAILED on: 3DIoU" in err


@pytest.mark.parametrize("which", [0, 1])
def test_no_pano_exits_1(tools, tmp_path, capsys, which):
    argv = ["--pth", CKPT, "--img_glob", str(tmp_path / "none" / "*"),
            "--gt_glob", str(tmp_path / "*txt")]
    argv += ["--device", "cpu"] if which == 0 else []
    assert tools[which].main(argv) == 1
    assert "no panos match" in capsys.readouterr().err


def test_root_dir_is_required_as_in_jax(tools, capsys):
    errs = []
    for tool in tools:
        with pytest.raises(SystemExit) as e:
            tool.main(["--pth", CKPT, "--img_glob", "x/*"])
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.splitlines()[-1])
    assert errs[0] == errs[1]
    assert "--root_dir is required unless BOTH" in errs[0]


def test_presets_and_tolerances_equal_jax(tools):
    port, jax_tool = tools
    assert port.PRESETS == jax_tool.PRESETS
    assert port.DEFAULT_TOL == jax_tool.DEFAULT_TOL
    assert port.PRESETS["panocontext"]["expect"]["3DIoU"] == 83.39
    assert port.PRESETS["zind_raw"]["force_raw"] is True


def test_cuda_without_cuda_raises(tools, dataset, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tools[0].main(_argv(dataset, tmp_path, "general"))


# Run in a fresh process: the tool, on a raw pano (val_room turned by a
# known R) with --need_preprocess; it prints its exit code and whether jax
# or the JAX package was imported.
_FRESH = """
import json, runpy, sys
sys.argv = [sys.argv[1]] + sys.argv[2:]
rc = None
try:
    runpy.run_path(sys.argv[0], run_name='__main__')
except SystemExit as e:
    rc = e.code
print('FRESH ' + json.dumps([rc, sorted(
    m for m in sys.modules
    if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'horizonnet_tpu'))]))
"""


@pytest.fixture(scope="module")
def preprocess_run(dataset, tmp_path_factory):
    raw = tmp_path_factory.mktemp("raw")
    os.makedirs(raw / "img")
    pano = read_png(os.path.join(FIXDIR, "val_room.png"))[..., :3]
    write_png(str(raw / "img" / "val_room.png"),
              rotate_panorama_uint8_host(pano, R=yaw_tilt(20, 8)))
    shutil.copytree(dataset / "label_cor", raw / "label_cor")
    out = tmp_path_factory.mktemp("out_pre")
    env = dict(os.environ, PYTHONPATH="")
    env.pop("HORIZONNET_PREPROCESS_BACKEND", None)
    proc = subprocess.run(
        [sys.executable, "-c", _FRESH, PORT_TOOL,
         *_argv(raw, out, "general", "--device", "cpu",
                "--need_preprocess")], cwd=str(raw), env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    found = [json.loads(line[6:]) for line in proc.stdout.splitlines()
             if line.startswith("FRESH ")]
    assert len(found) == 1, proc.stdout[-4000:]
    return raw, out, found[0]


def test_need_preprocess_aligns_as_the_preprocess_cli(preprocess_run,
                                                      tmp_path, monkeypatch):
    raw, out, (rc, _) = preprocess_run
    assert rc == 0
    assert len(glob.glob(str(out / "dt" / "*.json"))) == 1
    monkeypatch.delenv("HORIZONNET_PREPROCESS_BACKEND", raising=False)
    assert preprocess.main(["--img_glob", str(raw / "img" / "*"),
                            "--output_dir", str(tmp_path), "--rgbonly",
                            "--device", "cpu"]) == 0
    names = sorted(os.listdir(out / "aligned"))
    assert names == sorted(os.listdir(tmp_path)) == ["val_room.png"]
    assert (out / "aligned" / names[0]).read_bytes() == \
        (tmp_path / names[0]).read_bytes()


def test_tool_imports_no_jax(preprocess_run):
    assert preprocess_run[2][1] == []
