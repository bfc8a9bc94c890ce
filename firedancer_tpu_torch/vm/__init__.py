"""vm: sBPF virtual machine (copy of the JAX package's vm/; ref:
src/flamenco/vm/). Host code, as in the reference: nothing here runs on
the card."""
from .asm import asm  # noqa: F401
from .interp import (  # noqa: F401
    ERR_ABORT, ERR_BAD_OP, ERR_BUDGET, ERR_DEPTH, ERR_DIV0, ERR_NONE,
    ERR_OOB, ERR_PC, ERR_SYSCALL, HEAP_START, INPUT_START, RODATA_START,
    STACK_START, Vm, VmFault, VmResult,
)
from .syscalls import DEFAULT_SYSCALLS, syscall_id  # noqa: F401
