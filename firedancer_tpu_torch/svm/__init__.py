"""svm: system-program transfer execution in conflict-free waves (the
port's copy of the JAX package's svm/executor.py and the account record
of svm/accdb.py). The full host SVM (exec="general": programs, vote,
stake, ALUT, precompiles, sBPF) is ROADMAP.md queue A item 15."""
from .accdb import Account  # noqa: F401
from .executor import (SystemTxn, execute_block, execute_block_serial,  # noqa: F401
                       STATUS_OK, STATUS_INSUFFICIENT, STATUS_FEE_FAIL)
