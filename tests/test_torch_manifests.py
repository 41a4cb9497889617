"""The port's k8s manifests against the reference's (platform/k8s.py).

``build_manifests`` of the port's CR and the reference's ``build_manifests``
of ``deploy/platform_cr.yaml`` give the same files; each document equals
the reference's once three fields are mapped back: the container command's
``ccfd_tpu_torch`` module, the image ``ccfd-tpu-torch:latest``, and the
scorer's ``resources.limits`` ``{"nvidia.com/gpu": 1}`` (the reference's
``{"google.com/tpu": 1}``). Nothing else may differ. ``manifests --out``
writes the rendered documents. Tolerance: none.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import yaml

from ccfd_tpu.config import Config as RefConfig
from ccfd_tpu.platform import k8s as ref_k8s
from ccfd_tpu.platform.operator import PlatformSpec as RefSpec
from ccfd_tpu_torch.config import Config
from ccfd_tpu_torch.platform import k8s as port_k8s
from ccfd_tpu_torch.platform.operator import PlatformSpec

REPO = Path(__file__).resolve().parents[1]
REF_CR = REPO / "deploy" / "platform_cr.yaml"
PORT_CR = REPO / "ccfd_tpu_torch" / "assets" / "platform_cr.yaml"


def _containers(doc):
    return doc.get("spec", {}).get("template", {}).get("spec", {}).get("containers", [])


def _back_to_reference(doc: dict) -> tuple[dict, list[str]]:
    """``doc`` with the three port fields mapped to the reference's, and
    the names of the fields that were mapped."""
    doc = copy.deepcopy(doc)
    mapped = []
    for c in _containers(doc):
        if c.get("image") == "ccfd-tpu-torch:latest":
            c["image"] = "ccfd-tpu:latest"
            mapped.append("image")
        cmd = c.get("command", [])
        if cmd[:3] == ["python", "-m", "ccfd_tpu_torch"]:
            c["command"] = ["python", "-m", "ccfd_tpu"] + cmd[3:]
            mapped.append("command")
        lim = c.get("resources", {}).get("limits")
        if lim == {"nvidia.com/gpu": 1}:
            c["resources"]["limits"] = {"google.com/tpu": 1}
            mapped.append("limits")
    return doc, mapped


def test_documents_differ_only_in_the_three_fields():
    ref = ref_k8s.build_manifests(RefSpec.from_yaml(str(REF_CR), cfg=RefConfig()), RefConfig())
    port = port_k8s.build_manifests(PlatformSpec.from_yaml(str(PORT_CR), cfg=Config()), Config())
    assert list(port) == list(ref)
    fields = []
    for name in ref:
        assert len(port[name]) == len(ref[name]), name
        for got, want in zip(port[name], ref[name]):
            back, mapped = _back_to_reference(got)
            assert back == want, name
            fields += mapped
    assert fields.count("limits") == 1  # the scorer's
    assert fields.count("image") == fields.count("command") == sum(
        len(_containers(d)) for docs in ref.values() for d in docs)
    scorer = next(d for d in port["scorer.yaml"] if d["kind"] == "Deployment")
    assert _containers(scorer)[0]["resources"] == {"limits": {"nvidia.com/gpu": 1}}


def test_same_cr_same_documents_through_either_spec():
    """The port's generator over the reference's CR (the refused blocks on)
    gives the same documents as over the port's CR: the manifests depend on
    the deployable components only."""
    a = port_k8s.build_manifests(PlatformSpec.from_yaml(str(REF_CR), cfg=Config()), Config())
    b = port_k8s.build_manifests(PlatformSpec.from_yaml(str(PORT_CR), cfg=Config()), Config())
    assert a == b


def test_manifests_command_writes_rendered_documents(tmp_path, capsys):
    from ccfd_tpu_torch.cli import main

    assert main(["manifests", "-f", str(PORT_CR), "--out", str(tmp_path / "k8s")]) == 0
    written = json.loads(capsys.readouterr().out)["written"]
    want = port_k8s.build_manifests(PlatformSpec.from_yaml(str(PORT_CR), cfg=Config()))
    assert sorted(Path(p).name for p in written) == sorted(want)
    for p in written:
        text = Path(p).read_text()
        assert text.startswith("# GENERATED by `python -m ccfd_tpu_torch manifests`")
        docs = [d for d in yaml.safe_load_all(text) if d is not None]
        assert docs == want[Path(p).name]
        assert port_k8s.render_yaml(want[Path(p).name]) in text


def test_the_references_checked_in_manifests_are_its_generators():
    """deploy/k8s holds the reference's own ``manifests`` output: the
    documents the smoke on the card (which imports nothing of the JAX
    package) holds the port's against."""
    ref = ref_k8s.build_manifests(RefSpec.from_yaml(str(REF_CR), cfg=RefConfig()), RefConfig())
    for name, docs in ref.items():
        text = (REPO / "deploy" / "k8s" / name).read_text()
        assert [d for d in yaml.safe_load_all(text) if d is not None] == docs, name
