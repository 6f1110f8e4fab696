"""GRO file reader/writer (counterpart of
``openmm_velocityverlet_tpu/models/grofile.py``; reference:
examples/ommhelper/grofile.py and the OpenMM GromacsGroFile it extends).
The numeric block is read by fixed columns in Python: the JAX package's
native C parser reads the same columns and gives the same arrays.

Reads positions (nm), optional velocities (nm/ps) and the box; writes frames
in the same fixed-width format, with optional atom subset and velocities.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class GroFile:
    def __init__(self, filename: str):
        with open(filename) as f:
            self.title = f.readline().rstrip("\n")
            n = int(f.readline())
            self.residue_ids = np.zeros(n, np.int32)
            self.residue_names = []
            self.atom_names = []
            lines = f.read().splitlines()
        for i in range(n):
            line = lines[i]
            self.residue_ids[i] = int(line[0:5])
            self.residue_names.append(line[5:10].strip())
            self.atom_names.append(line[10:15].strip())
        pos = np.zeros((n, 3), np.float64)
        vel = np.zeros((n, 3), np.float64)
        has_vel = False
        for i in range(n):
            line = lines[i]
            pos[i] = (float(line[20:28]), float(line[28:36]),
                      float(line[36:44]))
            if len(line.rstrip()) >= 68:
                vel[i] = (float(line[44:52]), float(line[52:60]),
                          float(line[60:68]))
                has_vel = True
        box_fields = [float(x) for x in lines[n].split()]
        self.positions = pos
        self.velocities = vel if has_vel else None
        # orthorhombic diagonal; off-diagonal terms unsupported (all bundled
        # models are rectangular)
        self.box = np.array(box_fields[:3], np.float64)
        if len(box_fields) > 3 and any(abs(x) > 1e-9 for x in box_fields[3:]):
            raise ValueError("triclinic boxes are not supported")

    def getPeriodicBoxVectors(self):
        return np.diag(self.box)

    def getUnitCellDimensions(self):
        return self.box.copy()

    @staticmethod
    def writeFile(topology, positions, box, file, time=None,
                  subset: Optional[Sequence[int]] = None, velocities=None):
        """Write a frame.  ``topology`` needs atom_names / residue_names /
        residue_ids arrays (our Topology or a GroFile).  Mirrors
        GroFile.writeFile (grofile.py:19-47)."""
        close = False
        if isinstance(file, str):
            file = open(file, "w")
            close = True
        t = 0.0 if time is None else float(time)
        print("written by openmm_velocityverlet_tpu_torch t = %.3f ps" % t,
              file=file)
        positions = np.asarray(positions)
        n = positions.shape[0]
        if subset is None:
            subset = range(n)
        print("%i" % len(subset), file=file)
        for i in subset:
            # element-like name: strip digits (grofile.py:105-108)
            name = "".join(c for c in topology.atom_names[i]
                           if not c.isdigit())
            line = "%5i%5s%5s%5i%8.3f%8.3f%8.3f" % (
                int(topology.residue_ids[i]) % 100000,
                topology.residue_names[i][:5], name[:5],
                (i + 1) % 100000,
                positions[i][0], positions[i][1], positions[i][2])
            if velocities is not None:
                v = velocities[i]
                line += "%8.4f%8.4f%8.4f" % (v[0], v[1], v[2])
            print(line, file=file)
        box = np.asarray(box).reshape(-1)
        print(" %.3f %.3f %.3f 0.0 0.0 0.0 0.0 0.0 0.0"
              % (box[0], box[1], box[2]), file=file)
        if close:
            file.close()
