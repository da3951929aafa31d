"""The port's native C ABI (``mh_tpu_torch/native/``) against ``mh_tpu``'s.

The same layouts (NumPy dtypes, C structs, the copied headers), the same
answers from the Python bridge on the same wire bytes (by
``assert_results_agree``'s rules), the port's C hosts and ``mh_tpu``'s
unchanged ones running against ``libmh_tpu_torch.so`` on the CPU, no
fallback to the CPU without a card, and the in-process ``ctypes`` call that
needs the library's interpreter-lock handling. The tests that build
something skip, as ``tests/test_native_abi.py`` does, where there is no
``g++``.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest

import mh_tpu_torch
from mh_tpu.native import bridge as JB
from mh_tpu_torch.native import _build, abi
from mh_tpu_torch.native import bridge as TB
import test_torch_threads  # noqa: F401
from test_torch_api import assert_results_agree

REPO = Path(__file__).resolve().parents[1]
JAX_NATIVE = REPO / "mh_tpu" / "native"
PORT_NATIVE = REPO / "mh_tpu_torch" / "native"
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")

DTYPES = {"mh_surface": "SURFACE_DT", "mh_relationship": "REL_DT",
          "mh_angle_relationship": "ANG_DT", "mh_pose": "POSE_DT", "mh_rect": "RECT_DT",
          "mh_config": "CONFIG_DT"}
SEEDS = (2**31 - 1, 2**31, 2**32 + 5, -1)


def env(**kw) -> dict:
    """This process's environment for a child: the repo importable, the
    port's device variable unset unless given."""
    out = {k: v for k, v in os.environ.items() if k != TB.DEVICE_ENV}
    out["PYTHONPATH"] = os.pathsep.join(filter(None, [str(REPO), out.get("PYTHONPATH")]))
    out.update(kw)
    return out


def as_result(buf: bytes, n_chains: int, n_objs: int):
    """run_wire's flat f64 buffer as a LayoutResult-shaped namespace."""
    a = np.frombuffer(buf, np.float64)
    pts = n_chains * n_objs * 6
    assert a.size == pts + 9 * n_chains
    return types.SimpleNamespace(
        points=a[:pts].reshape(n_chains, n_objs, 6), costs=a[pts:pts + 8 * n_chains].reshape(
            n_chains, 8), accept_rate=a[pts + 8 * n_chains:], step_scale=np.ones(n_chains))


@pytest.mark.parametrize("name", list(DTYPES.values()))
def test_wire_dtypes_match_mh_tpu(name):
    got, want = getattr(TB, name), getattr(JB, name)
    assert got.names == want.names
    assert got.itemsize == want.itemsize
    assert [got.fields[f][1] for f in got.names] == [want.fields[f][1] for f in want.names]
    assert got == want


@pytest.mark.parametrize("header", _build.HEADERS)
def test_headers_are_mh_tpus_up_to_comments(header):
    def code(path):
        text = re.sub(r"/\*.*?\*/", "", path.read_text(), flags=re.S)
        return re.sub(r"//[^\n]*", "", text).split()

    assert code(PORT_NATIVE / header) == code(JAX_NATIVE / header)
    assert "mh_tpu/" not in (PORT_NATIVE / header).read_text()


def test_no_port_source_includes_mh_tpu():
    for path in PORT_NATIVE.glob("*.[ch]*"):
        for inc in re.findall(r'#include\s+["<]([^">]+)', path.read_text()):
            assert "mh_tpu/" not in inc and not inc.startswith(".."), (path.name, inc)


@needs_gxx
def test_wire_h_layout_equals_dtypes(tmp_path):
    """A C program prints each struct's size and field offsets from the
    port's wire.h and ref_compat.h; they equal the dtypes and the ctypes
    structs of abi.py."""
    lines = ['#include <stddef.h>', '#include <stdio.h>', '#include "wire.h"',
             '#include "ref_compat.h"', "int main(void) {"]
    want = {}
    for struct, name in DTYPES.items():
        dt = getattr(TB, name)
        want[(struct, "")] = dt.itemsize
        lines.append(f'printf("{struct} . %zu\\n", sizeof({struct}));')
        for f in dt.names:
            want[(struct, f)] = dt.fields[f][1]
            lines.append(f'printf("{struct} {f} %zu\\n", offsetof({struct}, {f}));')
    want[("mh_result_costs", "")] = 8 * 8
    lines.append('printf("mh_result_costs . %zu\\n", sizeof(mh_result_costs));')
    for struct, cls in abi.REF_STRUCTS.items():
        want[(struct, "")] = ctypes.sizeof(cls)
        lines.append(f'printf("{struct} . %zu\\n", sizeof({struct}));')
        for f, _ in cls._fields_:
            want[(struct, f)] = getattr(cls, f).offset
            lines.append(f'printf("{struct} {f} %zu\\n", offsetof({struct}, {f}));')
    src = tmp_path / "layout.c"
    src.write_text("\n".join(lines + ["return 0;", "}"]))
    subprocess.run(["gcc", "-Wall", f"-I{PORT_NATIVE}", str(src), "-o", str(tmp_path / "layout")],
                   check=True, capture_output=True, timeout=60)
    out = subprocess.run([str(tmp_path / "layout")], check=True, capture_output=True, text=True)
    got = {}
    for line in out.stdout.splitlines():
        struct, field, value = line.split()
        got[(struct, "" if field == "." else field)] = int(value)
    assert got == want


@needs_gxx
@pytest.mark.parametrize("compiler", ["gcc", "g++"])
def test_ref_layout_asserts_compile(tmp_path, compiler):
    src = tmp_path / ("t.c" if compiler == "gcc" else "t.cpp")
    src.write_text('#include "ref_layout_asserts.h"\nint main(void) { return 0; }\n')
    subprocess.run([compiler, "-fsyntax-only", "-Wall", f"-I{PORT_NATIVE}", str(src)],
                   check=True, capture_output=True, timeout=60)


def test_wire_round_trip():
    spec = mh_tpu_torch.demo_scene(8)
    spec.frozen = np.arange(8) % 3 == 0
    cfg = mh_tpu_torch.SamplerConfig(iterations=7, n_chains=3, n_moves_per_step=2,
                                     accept_draws=5, beta=0.5,
                                     mode=mh_tpu_torch.CostMode.FIXED)
    got_spec, got_cfg, seed = TB.decode_wire(*TB.encode_wire(spec, cfg, -9))
    assert (got_cfg, seed) == (cfg, -9)
    for field in ("positions", "sizes", "frozen", "offlimit_quads", "surface_quad"):
        np.testing.assert_array_equal(getattr(got_spec, field), getattr(spec, field))
    for field in ("centroid", "focal", "focal_rot", "w_pairwise", "w_visual_balance", "w_focal",
                  "w_symmetry", "w_clearance", "w_offlimits", "w_surface_area",
                  "relationships", "angle_relationships"):
        np.testing.assert_equal(getattr(got_spec, field), getattr(spec, field), field)
    assert [(q.tolist(), s) for q, s in got_spec.clearances] == [
        (np.asarray(q).tolist(), s) for q, s in spec.clearances]
    # the wire's clamps and defaults, as mh_tpu's bridge decodes them
    srf, rels, angs, poses, clr, off, wire_cfg = TB.encode_wire(spec, cfg, 1)
    raw = np.frombuffer(wire_cfg, TB.CONFIG_DT).copy()
    raw["moves_per_step"], raw["accept_draws"], raw["beta"], raw["parity_mode"] = 0, -3, 0.0, 7
    _, clamped, _ = TB.decode_wire(srf, rels, angs, poses, clr, off, raw.tobytes())
    assert (clamped.n_moves_per_step, clamped.accept_draws) == (1, 1)
    assert clamped.beta == mh_tpu_torch.REF_BETA
    assert clamped.mode is mh_tpu_torch.CostMode.PARITY
    with pytest.raises(ValueError, match="adapt"):
        TB.encode_wire(spec, mh_tpu_torch.SamplerConfig(adapt=True), 0)


@pytest.mark.parametrize("mode", ["PARITY", "FIXED"])
@pytest.mark.parametrize("moves", [1, 4])
def test_bridge_matches_mh_tpu(mode, moves):
    """The port's run_wire on the CPU (the torch engine) against mh_tpu's
    (its XLA scan) on the same bytes; weighted FIXED has the off-limits
    term in the loop."""
    spec = mh_tpu_torch.demo_scene(8)
    if mode == "FIXED":
        spec.w_offlimits = -1.5
    cfg = mh_tpu_torch.SamplerConfig(iterations=50, n_chains=8, n_moves_per_step=moves,
                                     accept_draws=moves, mode=mh_tpu_torch.CostMode[mode])
    wire = TB.encode_wire(spec, cfg, 11)
    got = as_result(TB.run_wire(*wire, device="cpu"), 8, 8)
    want = as_result(JB.run_wire(*wire), 8, 8)
    same = assert_results_agree(got, want)
    assert (got.accept_rate[same] > 0).any()


@pytest.mark.parametrize("seed", SEEDS)
def test_int64_seeds_match_mh_tpu(seed):
    """Seeds from the wire are int64 (MH_TPU_SEED, the shim's wall-clock
    seed): both bridges key their engine with the seed mod 2^32."""
    spec = mh_tpu_torch.demo_scene(8)
    cfg = mh_tpu_torch.SamplerConfig(iterations=30, n_chains=4)
    wire = TB.encode_wire(spec, cfg, seed)
    got = as_result(TB.run_wire(*wire, device="cpu"), 4, 8)
    assert_results_agree(got, as_result(JB.run_wire(*wire), 4, 8))
    wrapped = as_result(TB.run_wire(*TB.encode_wire(spec, cfg, seed & 0xFFFFFFFF),
                                    device="cpu"), 4, 8)
    np.testing.assert_array_equal(got.points, wrapped.points)


def test_bridge_device_from_environment(monkeypatch):
    wire = TB.encode_wire(mh_tpu_torch.demo_scene(4), mh_tpu_torch.SamplerConfig(
        iterations=5, n_chains=2), 0)
    monkeypatch.setenv(TB.DEVICE_ENV, "cpu")
    assert TB.run_wire(*wire) == TB.run_wire(*wire, device="cpu")
    monkeypatch.delenv(TB.DEVICE_ENV)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TB.run_wire(*wire)


@needs_gxx
@pytest.mark.parametrize("host,line", [("test_wrapper", "native ABI smoke test OK"),
                                       ("test_ref_compat", "reference-ABI drop-in test OK")])
def test_port_c_hosts_on_cpu(host, line, tmp_path):
    run = subprocess.run([str(_build.build().host(host))], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=env(**{TB.DEVICE_ENV: "cpu"}))
    assert run.returncode == 0, f"stdout={run.stdout[-800:]}\nstderr={run.stderr[-800:]}"
    assert line in run.stdout
    if host == "test_wrapper":
        assert "costs: total=" in run.stdout and "backend: cpu" in run.stdout


@needs_gxx
@pytest.mark.parametrize("host,line", [("test_wrapper", "native ABI smoke test OK"),
                                       ("test_ref_compat", "reference-ABI drop-in test OK")])
def test_mh_tpu_c_hosts_link_the_port(host, line, tmp_path):
    """mh_tpu's unchanged C hosts, compiled against its own headers and
    linked to libmh_tpu_torch.so: the drop-in."""
    lib_dir = _build.build().directory
    exe = tmp_path / host
    subprocess.run(["gcc", str(JAX_NATIVE / f"{host}.c"), "-o", str(exe),
                    *_build.host_flags(JAX_NATIVE, lib_dir, rpath=str(lib_dir))],
                   check=True, capture_output=True, timeout=60)
    run = subprocess.run([str(exe)], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env=env(**{TB.DEVICE_ENV: "cpu"}))
    assert run.returncode == 0, f"stdout={run.stdout[-800:]}\nstderr={run.stderr[-800:]}"
    assert line in run.stdout


IN_PROCESS = textwrap.dedent("""
    import os, sys, threading
    import numpy as np
    import mh_tpu_torch as M
    from mh_tpu_torch.native import abi, bridge
    spec = M.demo_scene(8)
    cfg = M.SamplerConfig(iterations=40, n_chains=6, n_moves_per_step=2, accept_draws=2)
    wire = bridge.encode_wire(spec, cfg, 3)
    want = np.frombuffer(bridge.run_wire(*wire, device="cpu"), np.float64)
    if len(sys.argv) > 1:  # no device named, no card
        rc, points, costs, accept = abi.mh_kernel_wrapper(wire)
        assert rc != 0 and np.isnan(points).all() and np.isnan(costs).all()
        assert np.isnan(accept).all()
        print("NO FALLBACK", rc)
        sys.exit(0)
    outs = [abi.mh_kernel_wrapper(wire)]
    worker = threading.Thread(target=lambda: outs.append(abi.mh_kernel_wrapper(wire)))
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive() and len(outs) == 2
    for rc, points, costs, accept in outs:
        assert rc == 0
        got = np.concatenate([points.ravel(), costs.ravel(), accept.ravel()])
        assert got.tobytes() == want.tobytes()
    os.environ["MH_TPU_SEED"] = "3"
    points, costs = abi.kernel_wrapper(spec, 6, 2, 40)
    direct = M.suggest_layouts(spec, cfg, key=3, device="cpu")
    assert np.array_equal(points, direct.points) and np.array_equal(costs, direct.costs)
    rc, report = abi.mh_device_report()
    assert rc == 0 and "backend: cpu" in report
    print("IN PROCESS OK")
""")


@needs_gxx
def test_in_process_ctypes_call_takes_the_gil(tmp_path):
    """A fresh Python process loads the library with ctypes.CDLL (which
    drops the interpreter lock) and calls it from its main thread and from
    a second thread: both equal run_wire's bytes, and KernelWrapper equals
    the direct suggest_layouts call bit for bit."""
    _build.build()
    run = subprocess.run([sys.executable, "-c", IN_PROCESS], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=env(**{TB.DEVICE_ENV: "cpu"}))
    assert run.returncode == 0, f"stdout={run.stdout[-800:]}\nstderr={run.stderr[-2000:]}"
    assert "IN PROCESS OK" in run.stdout


@needs_gxx
def test_no_cpu_fallback_without_a_card(tmp_path):
    """Without MH_TPU_TORCH_DEVICE and without a card, MHKernelWrapper
    returns nonzero, stderr names CUDA and no output is written; the C host
    exits nonzero."""
    _build.build()
    no_card = env(CUDA_VISIBLE_DEVICES="")
    run = subprocess.run([sys.executable, "-c", IN_PROCESS, "no-card"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300, env=no_card)
    assert run.returncode == 0, f"stdout={run.stdout[-800:]}\nstderr={run.stderr[-2000:]}"
    assert "NO FALLBACK -4" in run.stdout and "CUDA" in run.stderr
    host = subprocess.run([str(_build.build().host("test_wrapper"))], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300, env=no_card)
    assert host.returncode != 0 and "CUDA" in host.stderr
    assert "MHKernelWrapper failed: -4" in host.stderr


def test_build_is_keyed_by_sources_and_flags(monkeypatch):
    first = _build.build_dir()
    assert first.parent == _build.BUILD_DIR and first == _build.build_dir()
    monkeypatch.setattr(_build, "REPO_ROOT", Path("/elsewhere"))
    assert _build.build_dir() != first
