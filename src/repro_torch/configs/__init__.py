from repro_torch.configs.base import (ArchSpec, LayerDef, ShapeSpec, SHAPES,
                                      SHAPE_GRID, LONG_CONTEXT_ARCHS,
                                      cell_is_runnable, reduced)
from repro_torch.configs.registry import ARCHS, ASSIGNED, PAPER_WORKLOADS, get_arch
