"""The paper's own workload: grappa-like MD systems (see core/md)."""
from repro_torch.core.md.system import GRAPPA_SIZES, make_grappa_like

make_system = make_grappa_like
SIZES = GRAPPA_SIZES
