"""The segment decoder's cost a step, part by part, chained timing.

The port of ``tools/probe_step_cost2.py`` (the JAX tool for its gen-2
kernel): the cases of ``probe_step_cost`` (spin mode, parts of the step
taken out, one build a case: ``ops/step_cost.py``), at 1,024 lanes by
default, timed over a chain of 8 calls in which each call's decoded
window is the next call's initial window, with CUDA events around the
chain. The JAX tool chained its calls so that its device could not answer
a repeated input from a cache; here the chain keeps the same meaning: 8
dependent calls back to back.

Usage (on the card; ``--device cpu`` runs the plain versions, timed by
the host clock)::

    python -m lzma_rs_tpu_torch.tools.probe_step_cost2 [L] [W] [RING]
        [NLIT] [NPS] [UNROLL] [--device cpu]

Prints ``RESULT <case> <x> us/step (<n> steps, <ms> ms/call)`` with the
cycles a step and the restarts; see ``probe_step_cost`` for the
arguments.
"""

from __future__ import annotations

from lzma_rs_tpu_torch.tools import probe_step_cost


def main(argv=None):
    """The command line (gen-2's tool: 8 chained calls)."""
    return probe_step_cost.run(argv, chained=True, default_lanes=1024)


if __name__ == "__main__":
    main()
