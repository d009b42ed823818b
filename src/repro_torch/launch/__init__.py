"""Entry points (port of ``repro.launch``): the trainer, the server, the
dry run and the paper tables as modules run with ``python -m``, and the
mesh constructors."""

from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh

__all__ = ["make_debug_mesh", "make_production_mesh"]
