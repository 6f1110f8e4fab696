"""The reference of the SWM4-NDP water (tables of
``benchmark/layouts/swm4_ndp.py``): the plain forces and TGNH middle step
of ``benchmark/reference.py`` on the traffic's reciprocal route, and the
water's own numbers, read on the port's window-end state:

* ``constraint_rel``: the widest relative deviation of a constraint (the
  hard wall moves a Drude's parent after SHAKE, so it is not the solver's
  tolerance);
* ``drude_nm``: the widest Drude distance, which the wall holds at the
  configuration's 0.02 nm, the limit the configuration states;
* ``temp_drude_k``: the Drude pairs' relative kinetic temperature, whose
  target is 1 K.

(The molecules' temperature is not compared: at the window's end it still
carries the heat of the lattice start, by an amount that follows the
number of steps the machine's speed fits into the window.  A thermostat
left out shows in the step gaps instead, since the chains are far from
rest there.)

The control is the same code in float32 with the route's rounding.
"""
from __future__ import annotations

import torch

from benchmark import reference


class Reference(reference.Reference):
    def numbers(self, s):
        """The window-end state's numbers, by name."""
        x = s["pos"] + s["pos_err"]
        i, j = self.cons[:, 0], self.cons[:, 1]
        r = torch.sqrt(torch.sum(self.mi(x[i] - x[j]) ** 2, -1))
        d = torch.sqrt(self.cons_d2)
        dr = x[self.drudes[:, 0]] - x[self.drudes[:, 1]]
        return {"constraint_rel": float(torch.max(torch.abs(r - d) / d)),
                "drude_nm": float(torch.sqrt(torch.sum(dr * dr, 1)).max()),
                "temp_drude_k": self.drude_temperature(s["vel"])}

    def stated_limits(self):
        """Limits the configuration states itself: the wall's distance."""
        return {"drude_nm": self.dmax}


def build(t, traffic, device, control=False):
    """The reference of the tables ``t`` on the traffic's route, or with
    ``control`` its control."""
    if control:
        return Reference(t, traffic, device, dtype=torch.float32,
                         control=True)
    return Reference(t, traffic, device)
