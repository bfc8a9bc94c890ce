"""choreo's eqvoc, notar, hfork and voter in the port (copies of the JAX
package's choreo/eqvoc.py, notar.py, hfork.py and voter.py) against the
reference's: each case of tests/test_choreo.py's eqvoc section and of
tests/test_notar_hfork.py runs on both packages in lockstep
(tests/torch_lockstep.py: every call's result and every detector's final
state equal, and the reference's asserts hold on both); the voter
accessors read the port's svm/vote.py account bytes exactly as the
reference's read its own."""
import pytest

import test_choreo
import test_notar_hfork
from torch_lockstep import lockstep, norm

from firedancer_tpu.choreo import voter as jvoter
from firedancer_tpu.svm import vote as jvote
from firedancer_tpu_torch.choreo import voter as tvoter
from firedancer_tpu_torch.svm import vote as tvote

EQVOC = {"EqvocDetector": "choreo.eqvoc.EqvocDetector",
         "FecMeta": "choreo.eqvoc.FecMeta"}
NOTAR_HFORK = {"Notar": "choreo.notar.Notar",
               "HforkDetector": "choreo.hfork.HforkDetector",
               "voter_mod": "choreo.voter"}


def _cases(mod, prefix):
    return sorted(n for n in vars(mod) if n.startswith(prefix))


@pytest.mark.parametrize("case", _cases(test_choreo, "test_eqvoc"))
def test_eqvoc_matches_reference(case):
    rec = lockstep(getattr(test_choreo, case), EQVOC)
    assert any(r[0] == "EqvocDetector" for r in rec)


@pytest.mark.parametrize("case", _cases(test_notar_hfork, "test_"))
def test_notar_hfork_voter_match_reference(case):
    rec = lockstep(getattr(test_notar_hfork, case), NOTAR_HFORK)
    assert rec


def _vote_state(vote_mod, slots, root):
    st = vote_mod.VoteState(b"\x01" * 32, b"\x02" * 32, b"\x03" * 32,
                            commission=5)
    for s in slots:
        st.tower.vote(s)
    st.root_slot = root
    return st.to_bytes()


def _read(voter_mod, data):
    out = {}
    for name in ("kind", "node_pubkey", "last_vote_slot", "root_slot",
                 "tower"):
        try:
            out[name] = norm(getattr(voter_mod, name)(data))
        except voter_mod.VoterError as e:
            out[name] = ("VoterError", str(e))
    return out


@pytest.mark.parametrize("slots,root", [
    ((), None), ((3,), None), ((1, 2, 3, 4, 5), None),
    (tuple(range(1, 40)), 7)])
def test_voter_reads_vote_program_accounts_as_reference(slots, root):
    """Each package's svm/vote.py state bytes are equal, and each
    package's accessors read them alike (the vote program's own layout
    is not the bincode one the accessors decode, so most reads raise:
    the same error with the same text on both)."""
    jdata = _vote_state(jvote, slots, root)
    tdata = _vote_state(tvote, slots, root)
    assert tdata == jdata
    assert _read(tvoter, tdata) == _read(jvoter, jdata)
