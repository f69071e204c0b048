"""halide_tpu_torch -- the PyTorch/CUDA port of halide_tpu.

The same Halide-style front end (Funcs defined apart from their schedules,
bounds inferred, tiled stages fused into one kernel), evaluated with torch and
with hand-written CUDA kernels for an NVIDIA Hopper card (sm_90a). The JAX
package `halide_tpu` stays beside it as the reference; this package imports
neither it nor jax.

What is ported: the front end, `Pipeline.realize`, whole-array evaluation
(eval_torch) with inline reductions and the convolution and einsum
contraction paths, the stencil-group kernel (ops/group_kernel), update
definitions (updates) with the scan kernel (ops/scan_kernel) and the
row-histogram kernel (ops/rowhist_kernel), rfactor, the print/error
hooks, and the surface around realize: specialize, wrapper Funcs, extern
stages, compile_to_callable, infer_input_bounds, serialization, tracing
(trace), the profile, memoize on the native host runtime (runtime),
debug_to_file, the loop nest (loopnest) and the HTML report (report); the
autoschedulers (autoschedule: Mullapudi2016, Adams2019, Anderson2021 and
Li2018, over a cost table fitted on the card, target.FITTED_COST), the
generator (generator: its artifacts, an exported program among them, whose
kernels are torch.library custom ops, ops/export_ops), the tools (tools:
gen, rungen, traceviz, tilesearch, fitcost, abtest) and
propagate_adjoints (derivative, through torch.autograd).
Realize, the tools and propagate_adjoints run on the card unless the
caller asks for the CPU.
"""
import sys as _sys

# deep pipelines recurse through the expression DAG; the reference's analog
# is HL_COMPILER_STACK_SIZE (reference: src/Util.h run_with_large_stack)
if _sys.getrecursionlimit() < 20000:
    _sys.setrecursionlimit(20000)

from .htypes import (Type, Int, UInt, Float, BFloat, Bool, Handle)  # noqa: E402
from .expr import (Expr, CompileError, HalideError)                 # noqa: E402
from .func import Var, Func, Stage, FuncRef, _, TupleExpr as Tuple  # noqa: E402
from .rdom import RDom, RVar                                        # noqa: E402
from .buffer import Buffer, ImageParam, Param, Realization          # noqa: E402
from .pipeline import Pipeline                                      # noqa: E402
from .schedule import (TailStrategy, LoopLevel, ForType,            # noqa: E402
                       LoopAlignStrategy)
from .target import (Target, get_host_target,                       # noqa: E402
                     get_jit_target_from_environment,
                     get_target_from_environment)
from .iroperator import *                                           # noqa: E402,F401,F403
from .iroperator import __all__ as _irop_all                        # noqa: E402
from .inline_reductions import (sum, product, maximum, minimum,     # noqa: E402
                                argmax, argmin)
from .boundary import (repeat_edge, constant_exterior, repeat_image,  # noqa: E402
                       mirror_image, mirror_interior)
from . import boundary as BoundaryConditions                        # noqa: E402
from .hooks import set_custom_print, set_error_handler              # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Type", "Int", "UInt", "Float", "BFloat", "Bool", "Handle",
    "Expr", "CompileError", "HalideError",
    "Var", "Func", "Stage", "FuncRef", "_", "Tuple",
    "RDom", "RVar",
    "Buffer", "ImageParam", "Param", "Realization",
    "Pipeline", "TailStrategy", "LoopLevel", "ForType",
    "LoopAlignStrategy",
    "Target", "get_host_target", "get_jit_target_from_environment",
    "get_target_from_environment",
    "sum", "product", "maximum", "minimum", "argmax", "argmin",
    "repeat_edge", "constant_exterior", "repeat_image", "mirror_image",
    "mirror_interior", "BoundaryConditions",
    "set_custom_print", "set_error_handler",
] + list(_irop_all)

from .serialize import serialize_pipeline, deserialize_pipeline  # noqa: E402
from .derivative import propagate_adjoints                        # noqa: E402
__all__ += ["serialize_pipeline", "deserialize_pipeline",
            "propagate_adjoints"]
