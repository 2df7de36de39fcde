"""Structural rules of the PyTorch port.

* ``src/repro_torch`` and ``chip_smoke.py`` import no ``jax`` and nothing of
  the reference package ``repro`` (an AST scan, so a lazy import inside a
  function counts too).
* The port's entry points run on the card unless the caller asks for the
  CPU: without CUDA, ``rstorm-search``, ``build``, ``Model`` and
  ``ServingEngine`` raise unless ``device="cpu"``.
* The CUDA build targets Hopper (``sm_90a``) with ``-fmad=false``, for every
  source in ``csrc/``.
* The kernels' argument structs match their C layouts.
"""

from __future__ import annotations

import ast
import ctypes
import importlib
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from repro_torch import build  # noqa: E402
from torch_cases import compile_case  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def imported_modules(path: Path):
    """Absolute module names a file imports (relative imports resolve
    inside the port and are skipped)."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_reference(path):
    for name in imported_modules(path):
        root = name.split(".")[0]
        assert root != "jax", f"{path.name} imports {name}"
        assert root != "repro", f"{path.name} imports {name}"


def test_port_modules_do_not_load_jax_or_reference(tmp_path):
    """Importing the whole port in a fresh interpreter loads neither."""
    import subprocess

    code = (
        "import sys, repro_torch.core, repro_torch.stream, repro_torch.build\n"
        "import repro_torch.core.search.kernels, repro_torch.kernels, repro_torch.models\n"
        "import repro_torch.serve, repro_torch.configs, repro_torch.data\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=tmp_path, env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_search_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.get_scheduler("rstorm-search")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.get_scheduler("rstorm-search", device="cuda")
    assert P.get_scheduler("rstorm-search", device="cpu").device.type == "cpu"
    *_, ba, _ = compile_case(P, "linear_net", with_tm=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ba.to(None)


def test_lm_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    from repro_torch.configs import get_smoke
    from repro_torch.models import Model, build as build_model
    from repro_torch.serve import ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("qwen3-0.6b")
    # The engine runs on its model's device: without a card it can only be
    # made around a model that was asked onto the CPU.
    for make in (lambda: build_model("qwen3-0.6b", smoke=True), lambda: Model(cfg),
                 lambda: build_model("qwen3-0.6b", smoke=True, device="cuda"),
                 lambda: ServingEngine(build_model("qwen3-0.6b", smoke=True))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    model = build_model("qwen3-0.6b", smoke=True, device="cpu")
    assert model.device.type == "cpu" and Model(cfg, device="cpu").device.type == "cpu"
    assert ServingEngine(model).device.type == "cpu"


def test_port_registry_is_its_own():
    import repro.core as R

    assert P.scheduler_names() == ["rstorm", "rstorm-search"]
    assert P.REGISTRY is not R.REGISTRY
    assert "device" in P.REGISTRY["rstorm-search"].kwargs_schema
    assert "backend" not in P.REGISTRY["rstorm-search"].kwargs_schema
    with pytest.raises(ValueError, match="slice"):
        P.get_scheduler("rstorm-search", init="all-registered", device="cpu")


CUDA_SOURCES = sorted(p.stem for p in (REPO / "src" / "repro_torch" / "csrc").glob("*.cu"))


def test_every_cuda_source_is_a_kernel_of_the_port():
    assert CUDA_SOURCES == ["decode_attention", "flash_attention", "fused_score", "grouped_gemm", "rglru_scan"]


def test_build_command_targets_hopper_without_fma(monkeypatch):
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    for name in CUDA_SOURCES:
        out = build.library_path(name)
        cmd = build.build_command(name, out)
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-fmad=false" in cmd
        assert not any("fast_math" in c or "fast-math" in c for c in cmd)
        assert cmd[-1].endswith(f"csrc/{name}.cu")
        assert out.parent == REPO / "build" / "kernels"
        assert out.name.startswith(f"{name}-") and out.suffix == ".so"


def c_struct_fields(source: str, struct: str):
    """Field names of ``struct`` in ``csrc/<source>.cu``, in order."""
    text = (REPO / "src" / "repro_torch" / "csrc" / f"{source}.cu").read_text()
    body = text[text.index("struct " + struct):]
    declared = []
    for line in body[:body.index("};")].splitlines()[1:]:
        if ";" in line:  # "long long q_sb, q_sh, q_ss;  // ..." declares three
            declared += [part.split()[-1] for part in line.split(";")[0].replace("*", " ").split(",")]
    return declared


@pytest.mark.parametrize("module,struct", [
    ("repro_torch.kernels.flash.flash_attention", "_FlashArgs"),
    ("repro_torch.kernels.decode_attn.decode_attention", "_DecodeArgs"),
])
def test_attention_argument_structs_match_their_c_layout(module, struct):
    """Pointers and strides are 8 bytes, then one float and the ints (4
    bytes each), padded to 8 — the layout of the C struct, whose fields are
    listed in the same order in the .cu source."""
    mod = importlib.import_module(module)
    cls = getattr(mod, struct)
    n8 = len(mod._PTR_FIELDS) + len(mod._STRIDE_FIELDS)
    n4 = 1 + len(mod._INT_FIELDS)
    assert ctypes.sizeof(cls) == 8 * n8 + 4 * n4 + (4 * n4) % 8
    assert c_struct_fields(mod.__name__.split(".")[-1], struct[1:]) == [n for n, _ in cls._fields_]


def test_grouped_gemm_argument_struct_matches_its_c_layout():
    """Three pointers, then five ints, padded to 8 — the fields of ``struct
    GroupedGemmArgs`` in the same order."""
    mod = importlib.import_module("repro_torch.kernels.moe_gemm.grouped_gemm")
    cls = mod._GroupedGemmArgs
    assert ctypes.sizeof(cls) == 8 * len(mod._PTR_FIELDS) + 4 * len(mod._INT_FIELDS) + 4
    assert c_struct_fields("grouped_gemm", "GroupedGemmArgs") == [n for n, _ in cls._fields_]


def test_rglru_scan_argument_struct_matches_its_c_layout():
    """Four pointers, then four ints — the fields of ``struct RglruArgs`` in
    the same order, with no padding."""
    mod = importlib.import_module("repro_torch.kernels.rglru.rglru_scan")
    cls = mod._RglruArgs
    assert ctypes.sizeof(cls) == 8 * len(mod._PTR_FIELDS) + 4 * len(mod._INT_FIELDS)
    assert c_struct_fields("rglru_scan", "RglruArgs") == [n for n, _ in cls._fields_]


def test_kernel_arguments_pack_from_uploaded_arena():
    """Every pointer field of the kernel's struct is filled from a table
    (or a per-call buffer), and the struct matches the C layout."""
    fs = importlib.import_module("repro_torch.core.search.kernels.fused_score")
    *_, ba, tm = compile_case(P, "pageload")
    tables, scalars, dims = fs._pack(ba.to("cpu"), tm.to("cpu"))
    per_call = {"P", "out_net", "out_viol", "out_dead", "out_tp"}
    assert set(tables) | per_call == set(fs._PTR_FIELDS)
    args = fs._FusedArgs(B=4, **dims, **scalars)
    for name, tensor in tables.items():
        assert tensor.is_contiguous(), name
        setattr(args, name, tensor.data_ptr())
    assert ctypes.sizeof(args) == 8 * (len(fs._PTR_FIELDS) + len(fs._DOUBLE_FIELDS)) + 4 * len(
        fs._INT_FIELDS
    )
    assert tables["ack_tab"].numel() == 2 * dims["n_dp"] + 1 + 2 * dims["n_pairs"] + dims["n_spouts"]
    *_, solo, solo_tm = compile_case(P, "solo")
    tables, _, dims = fs._pack(solo.to("cpu"), solo_tm.to("cpu"))
    assert dims["E"] == 1 and tables["evalid"].tolist() == [0.0]
