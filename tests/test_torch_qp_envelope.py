"""The clip envelope of the constrained loop (``bench.batch.qp_envelope``):
the port's float64 plaintext mirror sizes B0 for 40-step episodes, a
non-finite certificate doubles B0, and an envelope that never fits is
refused.  CPU, mirror only; no JAX."""

import numpy as np
import pytest
import torch

from hectr_tpu_torch import cli
from hectr_tpu_torch.bench import batch as BB


def test_envelope_sizes_a_40_step_episode_at_1_5x_the_step():
    """At 1.5x the published inlet step the loop leaves the clip's fit
    domain at B0 = 4 (its certificate goes non-finite); doubled to 8 the
    certificate reads 8.56, so B0 becomes 10, under which all 40 steps
    stay finite and every move inside the box."""
    model, plant = cli.cstr_setup()
    p = BB.qp_disturbance(plant, 40, 1.5)
    B0, cert, x, u = BB.qp_envelope(model, plant, p)
    assert B0 == 10.0
    assert 8.0 < float(cert) <= B0
    assert np.isfinite(x).all() and np.isfinite(u).all()
    assert BB.qp_box_ok(np.concatenate([np.asarray(plant.us)[None], u]))


def test_the_configurations_envelope_certifies_its_traffic():
    """B0 = QP_INPUT_BOUND (12) fits the cell's traffic range at once:
    inlet steps of 0.5, 1 and 1.5x the published from steps 0, 10 and
    19, three loops in one mirror; the worst certificate is 8.73."""
    model, plant = cli.cstr_setup()
    p = np.zeros((9, 40, 1))
    for i, (scale, onset) in enumerate((s, o) for s in (0.5, 1.0, 1.5)
                                       for o in (0, 10, 19)):
        p[i, onset:, 0] = 0.01 * scale
    B0, cert, x, u = BB.qp_envelope(model, plant, p, BB.QP_INPUT_BOUND,
                                    runs=1)
    assert B0 == BB.QP_INPUT_BOUND
    assert cert.max() == pytest.approx(8.73, abs=0.01)
    assert np.isfinite(x).all()


class Script:
    """qp_envelope's mirror runs, scripted: a run at envelope B0 reads
    the certificate certificate[B0]; `given` lists the B0s run."""

    def __init__(self, certificate):
        self.certificate = certificate
        self.given = []


@pytest.fixture
def script(monkeypatch):
    """Install a Script for qp_envelope's mirror and closed loop."""
    from hectr_tpu_torch.hempc import qp_enc

    held = Script({})

    def mirror(*args, input_bound, **kwargs):
        held.given.append(input_bound)
        return input_bound

    def loop(model, plant, p, device, reg, state):
        cert = torch.tensor(held.certificate[reg], dtype=torch.float64)
        return np.zeros(1), np.zeros(1), cert
    monkeypatch.setattr(qp_enc, "make_pgd_mirror_regulator", mirror)
    monkeypatch.setattr(BB, "closed_loop", loop)
    return held


def test_a_non_finite_certificate_doubles_the_envelope(script):
    """NaN at 4 doubles B0 to 8; 9.5 there widens it to ceil + 1 = 11,
    where 10.2 fits."""
    script.certificate.update({4.0: float("nan"), 8.0: 9.5, 11.0: 10.2})
    B0, cert, _, _ = BB.qp_envelope(None, None, np.zeros((40, 1)))
    assert (B0, float(cert)) == (11.0, 10.2)
    assert script.given == [4.0, 8.0, 11.0]


@pytest.mark.parametrize("cert", [float("nan"), float("inf")])
def test_an_envelope_that_never_fits_is_refused(script, cert):
    """A certificate that stays non-finite doubles B0 on every run and,
    after the last, raises."""
    script.certificate.update({4.0 * 2 ** i: cert for i in range(6)})
    with pytest.raises(ValueError, match="no clip envelope fits in 6 runs"):
        BB.qp_envelope(None, None, np.zeros((40, 1)))
    assert script.given == [4.0 * 2 ** i for i in range(6)]
