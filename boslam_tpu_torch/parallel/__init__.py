"""Distribution layer (``boslam_tpu.parallel``): process-group meshes,
landmark-sharded local and global BA over ``torch.distributed``, the
multi-sequence engine and the multi-process bootstrap.

Everything is lazy, as in the reference: ``import boslam_tpu_torch`` never
initialises ``torch.distributed``, and ``parallel.distributed`` must bring
the process group up before the CLI touches CUDA.
"""

__all__ = [
    "make_mesh", "sharded_ba", "multi", "sharded_global_ba",
    "mesh", "distributed",
]

_SUBMODULES = ("sharded_ba", "multi", "sharded_global_ba",
               "mesh", "distributed")


def __getattr__(name):
    import importlib

    if name == "make_mesh":
        return importlib.import_module(
            "boslam_tpu_torch.parallel.mesh").make_mesh
    if name in _SUBMODULES:
        return importlib.import_module(f"boslam_tpu_torch.parallel.{name}")
    raise AttributeError(name)
