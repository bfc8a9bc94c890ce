"""Both packages' host executors side by side, for the parity files of the
vote, stake, lookup-table, precompile and rewards programs, the
upgradeable loader and deployed sBPF programs
(tests/test_torch_vote_program.py, test_torch_stake.py, test_torch_alut.py,
test_torch_precompiles.py, test_torch_rewards.py, test_torch_loader.py,
test_torch_elf_cpi.py, test_torch_bpf_programs.py). `Both` holds the JAX
package's and the port's TxnExecutor, each over its own Funk with the same
root accounts and one prepared fork "blk"; every step runs on both and
asserts equal results (status, fee, logs, return data) and equal forks,
so a test reads as the reference's own test does."""
import importlib

from firedancer_tpu.protocol.txn import build_message, build_txn

MODS = ("funk.funk", "svm.accdb", "svm.programs", "svm.vote", "svm.stake",
        "svm.alut", "svm.precompiles", "svm.sysvars", "flamenco.stakes",
        "flamenco.rewards", "svm.loader", "vm.elf", "vm.asm")


class Pkg:
    """One package's modules by their short name: pkg.vote, pkg.rewards..."""

    def __init__(self, root):
        for m in MODS:
            setattr(self, m.split(".")[1],
                    importlib.import_module(f"{root}.{m}"))


JAX, TORCH = Pkg("firedancer_tpu"), Pkg("firedancer_tpu_torch")
PKGS = (JAX, TORCH)


def k(n):
    return bytes([n]) * 32


def txn(signers, extra, instrs, n_ro_unsigned=0, blockhash=b"\x11" * 32,
        **kw):
    """Unsigned-signature txn (the executor does not re-verify
    signatures: the verify tile did)."""
    return build_txn([bytes(64)] * len(signers), build_message(
        signers, extra, blockhash, [(p, bytes(a), d) for p, a, d in instrs],
        n_ro_unsigned=n_ro_unsigned, **kw))


def fork_state(funk, pkg, xid="blk"):
    return {key: (v.lamports, bytes(v.data), v.owner, v.executable,
                  v.rent_epoch)
            for key, v in funk.items_at(xid).items()
            if isinstance(v, pkg.accdb.Account)}


class Both:
    def __init__(self, accounts, enforce_rent=True, slot=0, epoch=0):
        self.envs = []
        for pkg in PKGS:
            funk = pkg.funk.Funk()
            for key, a in accounts.items():
                a = {"lamports": a} if isinstance(a, int) else a
                funk.rec_write(None, key, pkg.accdb.Account(**a))
            funk.txn_prepare(None, "blk")
            ex = pkg.programs.TxnExecutor(pkg.accdb.AccDb(funk),
                                          enforce_rent=enforce_rent)
            ex.slot, ex.epoch = slot, epoch
            self.envs.append((pkg, funk, ex))

    def write(self, key, **a):
        for pkg, funk, _ in self.envs:
            funk.rec_write("blk", key, pkg.accdb.Account(**a))

    def set(self, **kw):
        for _, _, ex in self.envs:
            for name, v in kw.items():
                setattr(ex, name, v)

    def run(self, payload) -> str:
        """Execute on both; results and forks must be equal. -> status."""
        return self.result(payload)[0]

    def result(self, payload) -> tuple:
        """Execute on both; results and forks must be equal. -> the
        port's (status, fee, logs, return data)."""
        got = []
        for pkg, funk, ex in self.envs:
            r = ex.execute("blk", payload)
            got.append(((r.status, r.fee, list(r.logs), r.return_data),
                        fork_state(funk, pkg)))
        assert got[1] == got[0]
        return got[1][0]

    def call(self, fn):
        """fn(pkg, funk) on both; the results and forks must be equal.
        -> the port's result."""
        got = []
        for pkg, funk, _ in self.envs:
            got.append((fn(pkg, funk), fork_state(funk, pkg)))
        assert got[1] == got[0]
        return got[1][0]

    def account(self, key):
        pkg, funk, _ = self.envs[1]
        return pkg.accdb.AccDb(funk).peek("blk", key)
