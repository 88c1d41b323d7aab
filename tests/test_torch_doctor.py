"""The port's ``doctor`` (``utils/doctor.py``) on the CPU, against the
JAX package's: the report's shape, the probe's timeout as data, and the
CLI's exit codes.  Here there is no card, so the default probe is
unhealthy and exits 3: it never falls back to the CPU."""

import json

import torch

from ndivplanning_tpu.cli import main as jax_main
from ndivplanning_tpu.utils.doctor import doctor_report as jax_doctor_report
from ndivplanning_tpu_torch.cli import main
from ndivplanning_tpu_torch.utils.doctor import doctor_report, probe_backend


def test_report_without_probe_is_host_introspection_as_in_jax():
    r, jr = doctor_report(probe=False), jax_doctor_report(probe=False)
    assert r["package_version"] and r["python"] == jr["python"]
    assert r["torch"] == torch.__version__
    assert "backend_probe" not in r and "healthy" not in r
    assert "backend_probe" not in jr and "healthy" not in jr
    assert set(r["native_host_plane"]) == set(jr["native_host_plane"]) == {
        "available", "lib_built"}
    assert r["native_host_plane"]["available"] is True
    assert set(r["ndiv_kernels"]) == {"library", "built"}
    assert r["ndiv_kernels"]["library"].startswith(
        "ndivplanning_tpu_torch/_build/libndiv_")
    assert "nvcc" in r


def test_cpu_probe_healthy():
    p = probe_backend(timeout_s=300.0, platform="cpu")
    assert p["status"] == "healthy", p
    assert p["device"] == "cpu" and p["device_count"] == 1
    assert p["probe_value_ok"] is True and p["device_name"]


def test_probe_timeout_is_data_not_hang():
    p = probe_backend(timeout_s=0.01)
    assert p["status"] == "timeout" and p["timeout_s"] == 0.01
    assert "hint" in p


def test_default_probe_without_a_card_is_unhealthy():
    p = probe_backend(timeout_s=300.0)
    if torch.cuda.is_available():
        assert p["status"] == "healthy" and p["device"] == "cuda"
    else:
        assert p["status"] == "unhealthy" and p["device"] == "cuda"
        assert any("CUDA is not available" in line
                   for line in p["stderr_tail"])


def test_cli_doctor_no_probe_exits_zero_as_in_jax(capsys):
    assert jax_main(["doctor", "--no-probe"]) == 0
    jreport = json.loads(capsys.readouterr().out)
    assert main(["doctor", "--no-probe"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert "backend_probe" not in report and "backend_probe" not in jreport


def test_cli_doctor_cpu_probe_exits_zero(capsys):
    assert main(["doctor", "--probe-cpu", "--probe-timeout", "300"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["healthy"] is True
    assert report["backend_probe"]["device"] == "cpu"


def test_cli_doctor_default_probe_exits_3_without_a_card(capsys):
    rc = main(["doctor", "--probe-timeout", "300"])
    report = json.loads(capsys.readouterr().out)
    assert report["healthy"] is torch.cuda.is_available()
    assert rc == (0 if torch.cuda.is_available() else 3)


def test_cli_doctor_timeout_exits_3(capsys):
    assert main(["doctor", "--probe-timeout", "0.01"]) == 3
    report = json.loads(capsys.readouterr().out)
    assert report["backend_probe"]["status"] == "timeout"
    assert report["healthy"] is False
