"""svm: system-program transfer execution in conflict-free waves, and the
host executor the bank's exec="general" and the follower's replay run
(the port's copies of the JAX package's svm/executor.py, svm/accdb.py,
svm/sysvars.py, svm/programs.py with the vote, stake, lookup-table and
precompile programs of svm/vote.py, svm/stake.py, svm/alut.py and
svm/precompiles.py, the upgradeable loader svm/loader.py with CPI and
the sBPF VM of vm/, svm/accdb_cold.py over groove/, and
svm/txncache.py)."""
from .accdb import AccDb, Account, RwHandle  # noqa: F401
from .executor import (SystemTxn, execute_block, execute_block_serial,  # noqa: F401
                       STATUS_OK, STATUS_INSUFFICIENT, STATUS_FEE_FAIL)
from .programs import TxnExecutor, TxnResult  # noqa: F401
from .txncache import MAX_CACHE_AGE_SLOTS, TxnCache  # noqa: F401
