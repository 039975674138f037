"""The port covers the JAX package module for module: every top-level
function and class of every `lidargs_tpu` module has a counterpart of the
same name in the same module of `lidargs_torch`, or is listed below with its
reason: a counterpart under another name or in another module (checked to
exist), or a piece of JAX-only mechanics.

Both packages are read with `ast`; nothing is imported.
"""
import ast
from pathlib import Path

import pytest

from lidargs_torch.utils.testing import one_torch_thread

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "lidargs_tpu", ROOT / "lidargs_torch"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


# JAX modules that have no module of the same path in the port: every name in
# them is JAX-only or listed in ELSEWHERE
JAX_ONLY_MODULES = {
    "ops/pallas_composite.py": "Pallas kernels K1-K4 and their grid/VJP plumbing; the port's "
                               "are csrc/composite_fwd.cu and composite_bwd.cu, bound in "
                               "ops/composite_kernel.py",
    "ops/pallas_surfel.py": "Pallas kernels K5-K8 and their grid/VJP plumbing; the port's are "
                            "csrc/surfel_fwd.cu and surfel_bwd.cu, bound in ops/surfel_kernel.py",
    "native/__init__.py": "ctypes loader of the JAX package's C++ host library; the port does "
                          "that work in torch on the device",
    "native/build.py": "g++ build of the JAX package's C++ host library",
}

# (JAX module, name) -> (port module, port name, reason)
ELSEWHERE = {
    ("ops/pallas_composite.py", "composite_tiles_pallas"):
        ("ops/composite_kernel.py", "composite_tiles", "K1/K2 behind one autograd function"),
    ("ops/pallas_composite.py", "composite_windows_pallas"):
        ("ops/composite_kernel.py", "composite_windows", "K3/K4 behind one autograd function"),
    ("ops/pallas_composite.py", "mask_unwritten_rows"):
        ("ops/composite_kernel.py", "composite_windows_bwd",
         "K4 writes only the owned rows of a zeroed dbuf, which is the masked dbuf"),
    ("ops/pallas_surfel.py", "surfel_composite_tiles"):
        ("ops/surfel_kernel.py", "surfel_composite_tiles", "K5/K6 behind one autograd function"),
    ("ops/pallas_surfel.py", "surfel_composite_windows"):
        ("ops/surfel_kernel.py", "surfel_composite_windows",
         "K7/K8 behind one autograd function"),
    ("native/__init__.py", "knn3_mean_sq_dist"):
        ("ops/knn.py", "knn3_mean_sq_dist",
         "the exact 3-NN on the device: kernel N3 of csrc/knn.cu on a card"),
    ("native/__init__.py", "voxel_unique"):
        ("models/field.py", "voxelize_points", "the voxel dedup on the device"),
    ("native/__init__.py", "pano_to_points"):
        ("lidar/pano.py", "pano_to_lidar_with_intensities", "the back-projection on the device"),
    ("ops/rasterize.py", "_perm_rows_fwd"):
        ("ops/rasterize.py", "_PermutationRows", "a custom VJP's halves are one autograd.Function"),
    ("ops/rasterize.py", "_perm_rows_bwd"):
        ("ops/rasterize.py", "_PermutationRows", "a custom VJP's halves are one autograd.Function"),
    ("ops/projection.py", "_pg_hv_fwd"):
        ("ops/projection.py", "_PreprocessHV", "a custom VJP's forward is an autograd.Function"),
    ("models/raydrop.py", "_double_conv"):
        ("models/raydrop.py", "DoubleConv", "a functional layer is an nn.Module"),
    ("models/raydrop.py", "_init_double_conv"):
        ("models/raydrop.py", "DoubleConv", "its parameters are the module's"),
    ("models/raydrop.py", "_attn"):
        ("models/raydrop.py", "AttnBlock", "a functional layer is an nn.Module"),
    ("models/raydrop.py", "_init_attn"):
        ("models/raydrop.py", "AttnBlock", "its parameters are the module's"),
    ("train/lpips.py", "_vgg_features"):
        ("train/lpips.py", "LPIPS", "the VGG trunk is the module's forward"),
    ("utils/serialization.py", "_path_str"):
        ("utils/serialization.py", "tree_paths", "nested dicts' key paths, without jax.tree_util"),
}

# (JAX module, name) -> reason it has no counterpart
JAX_ONLY = {
    ("models/field.py", "_maybe_remat"):
        "jax.checkpoint around the projection; the port checkpoints with "
        "torch.utils.checkpoint inside render_field (remat_projection)",
    ("ops/rasterize.py", "_use_pallas"):
        "picks the Pallas backend on a TPU; the port's wrappers launch their kernel on a CUDA "
        "tensor",
    ("ops/knn.py", "_chunk_knn_sqdist"):
        "a lax.map chunk body; on a card knn_sqdist launches kernel N2 of csrc/knn.cu, "
        "on the CPU its plain version loops over chunks",
    ("models/raydrop.py", "_conv"): "a functional convolution; the port's is nn.Conv2d",
    ("models/raydrop.py", "_bn"): "a functional batch norm; the port's is nn.BatchNorm2d",
    ("train/lpips.py", "_conv3x3"): "a functional convolution; the port's is nn.Conv2d",
    ("train/lpips.py", "_maxpool2"): "a reduce_window pool; the port's is F.max_pool2d",
    ("parallel/mesh.py", "replicated"):
        "a NamedSharding over a jax Mesh; the port keeps whole tensors in each process",
    ("parallel/mesh.py", "frame_sharded"):
        "a NamedSharding over a jax Mesh; the port's ranks take their frames (parallel/shard.py)",
    ("parallel/mesh.py", "tile_sharding"):
        "a NamedSharding over a jax Mesh; the port's ranks take their tiles "
        "(parallel/sharded_render.py)",
    ("native/__init__.py", "native_available"):
        "whether the C++ host library loaded; the port has no host library",
    ("native/build.py", "ensure_built"): "builds the C++ host library with g++",
    ("parallel/sharded_render.py", "_param_specs"):
        "shard_map PartitionSpecs; the port's ranks hold the parameters whole",
}


def _top_names(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))}


def _modules(pkg: Path) -> dict:
    return {p.relative_to(pkg).as_posix(): p for p in sorted(pkg.rglob("*.py"))}


JAX_MODULES, PORT_MODULES = _modules(JAX_PKG), _modules(PORT_PKG)


def _port_names(module: str) -> set:
    return _top_names(PORT_MODULES[module]) if module in PORT_MODULES else set()


@pytest.mark.parametrize("module", sorted(JAX_MODULES))
def test_every_name_has_a_counterpart(module):
    if module not in PORT_MODULES:
        assert module in JAX_ONLY_MODULES, f"no lidargs_torch/{module}"
    port = _port_names(module)
    missing = []
    for name in sorted(_top_names(JAX_MODULES[module])):
        if name in port or (module, name) in JAX_ONLY:
            continue
        if (module, name) in ELSEWHERE:
            where, other, _ = ELSEWHERE[(module, name)]
            assert other in _port_names(where), f"{module}::{name} -> {where}::{other} is gone"
            continue
        if module in JAX_ONLY_MODULES and name.startswith("_"):
            continue
        missing.append(name)
    assert not missing, f"lidargs_torch/{module} lacks {missing}"


def test_allow_lists_are_current():
    """Every listed name exists in the JAX package and has no counterpart of
    its own name in the port's module, and every entry carries a reason."""
    for module, reason in JAX_ONLY_MODULES.items():
        assert module in JAX_MODULES and module not in PORT_MODULES and reason
    for table in (ELSEWHERE, JAX_ONLY):
        for (module, name), entry in table.items():
            assert name in _top_names(JAX_MODULES[module]), (module, name)
            assert name not in _port_names(module), f"{module}::{name} is ported: unlist it"
            assert (entry[-1] if isinstance(entry, tuple) else entry).strip()
