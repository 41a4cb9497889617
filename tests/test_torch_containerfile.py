"""The port's Containerfile (``Containerfile.torch``), checked statically as
tests/test_k8s_manifests.py::test_containerfile_matches_manifests checks
the reference's: the image it builds is the one every port manifest names
(``platform/k8s.py::IMAGE``), every path it copies exists in the repo as a
real instruction, its base carries nvcc, its build stage prebuilds the kernel
libraries for sm_90a and the native host library from the sources in the
image, and nothing of JAX is installed. The image itself is built where it
is deployed (the build pulls a base image and wheels).
"""

from __future__ import annotations

import os
from pathlib import Path

import pytest

from ccfd_tpu_torch.platform.k8s import IMAGE, write_manifests
from ccfd_tpu_torch.platform.operator import PlatformSpec

REPO = Path(__file__).resolve().parents[1]
PORT_CR = REPO / "ccfd_tpu_torch" / "assets" / "platform_cr.yaml"


@pytest.fixture(scope="module")
def lines() -> list[str]:
    raw = (REPO / "Containerfile.torch").read_text()
    # comments satisfy nothing: only real instructions count (continuations
    # joined, so a RUN reads as one line)
    out, cur = [], ""
    for line in raw.splitlines():
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        cur += line.rstrip("\\").strip() + " "
        if not line.rstrip().endswith("\\"):
            out.append(cur.strip())
            cur = ""
    return out


def test_the_image_is_the_one_every_port_manifest_names(tmp_path):
    import yaml

    from ccfd_tpu_torch.config import Config

    written = write_manifests(PlatformSpec.from_yaml(str(PORT_CR), cfg=Config()),
                              str(tmp_path))
    images = set()
    for path in written:
        for doc in yaml.safe_load_all(Path(path).read_text()):
            if doc and doc.get("kind") == "Deployment":
                images.add(doc["spec"]["template"]["spec"]["containers"][0]["image"])
    assert images == {IMAGE} == {"ccfd-tpu-torch:latest"}
    assert f"`{IMAGE}`" in (REPO / "Containerfile.torch").read_text().splitlines()[0]


def test_every_copied_path_exists_as_a_real_instruction(lines):
    copies = [ln for ln in lines if ln.startswith("COPY") and "--from=" not in ln]
    for path in ("ccfd_tpu_torch", "checkpoints_gbt"):
        assert any(f" {path} " in ln + " " for ln in copies), f"no COPY ships {path!r}"
        assert (REPO / path).exists(), path
    for ln in copies:
        src = ln.split()[1]
        assert (REPO / src).exists(), src
    # serve's default MLP checkpoint ships inside the copied package
    assert (REPO / "ccfd_tpu_torch" / "assets" / "mlp_step_1200.npz").exists()
    assert not any(" ccfd_tpu " in ln + " " for ln in copies)  # not the reference


def test_the_base_has_nvcc_and_the_build_stage_prebuilds_for_sm_90a(lines):
    from ccfd_tpu_torch import native
    from ccfd_tpu_torch.ops import _build

    arg = [ln for ln in lines if ln.startswith("ARG BASE=")]
    assert arg and "cuda" in arg[0] and "devel" in arg[0]  # nvcc ships in devel
    assert [ln for ln in lines if ln.startswith("FROM")] == [
        "FROM ${BASE} AS build", "FROM ${BASE}"]
    build = [ln for ln in lines if ln.startswith("RUN") and "_build.build()" in ln]
    assert build and "native.build()" in build[0]
    assert "CCFD_NATIVE_MARCH=x86-64-v3" in build[0]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert set(_build.SOURCES) == {p.stem for p in (REPO / "ccfd_tpu_torch" / "ops" /
                                                    "csrc").glob("*.cu")}
    assert callable(native.build)
    # the prebuilt libraries land where the port looks: /app/build/ccfd_tpu_torch
    assert any(ln == "WORKDIR /app" for ln in lines)
    assert _build.BUILD_DIR.relative_to(REPO) == Path("build") / "ccfd_tpu_torch"
    env = [ln for ln in lines if ln.startswith("ENV")]
    assert env and "PYTHONPATH=/app" in env[0] and "CCFD_NATIVE_MARCH=x86-64-v3" in env[0]


def test_the_image_runs_the_port_and_installs_no_jax(lines):
    pip = [ln for ln in lines if "pip install" in ln]
    assert pip and "torch" in pip[0]
    assert not any(w in pip[0].split() for w in ("jax", "flax", "optax", "orbax-checkpoint",
                                                 "scikit-learn"))
    cmd = [ln for ln in lines if ln.startswith("CMD")]
    assert cmd == ['CMD ["python", "-m", "ccfd_tpu_torch", "--help"]']
    assert os.path.exists(REPO / "Containerfile")  # the reference's stays beside it
