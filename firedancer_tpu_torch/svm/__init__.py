"""svm: system-program transfer execution in conflict-free waves, and the
host executor the follower's replay runs (the port's copies of the JAX
package's svm/executor.py, svm/accdb.py, svm/sysvars.py and the system
program and ComputeBudget of svm/programs.py). The rest of the host SVM
(exec="general" on the bank; vote, stake, ALUT, precompiles, sBPF) is
ROADMAP.md queue A item 15."""
from .accdb import Account  # noqa: F401
from .executor import (SystemTxn, execute_block, execute_block_serial,  # noqa: F401
                       STATUS_OK, STATUS_INSUFFICIENT, STATUS_FEE_FAIL)
