"""The dependent chain of a kernel's loop, read from its SASS.

A probe row that is one dependent chain per thread cannot run faster than
that chain: the cycles of one iteration from a loop-carried value to its
next value. :func:`chain_cycles` models them on a loop body of ``(address,
instruction)`` pairs (``cuobjdump -sass``, as ``chip_smoke.py``'s
``sass_listing`` reads it): one warp issues in order, an instruction at
the earliest cycle after the one before it and after its source registers
and predicates are ready, and its destinations are ready ``LATENCY``
cycles later. The latencies are assumptions (a fixed-latency integer
instruction 4 cycles, a shared-memory load 30, a global or local access
400), not measurements; a store and a branch hold nothing but the issue
slot, and memory dependences are not seen. The result is the steady slope
over many iterations, so a chain through a loaded value counts each load
once an iteration however the body is laid out. ``chip_smoke.py`` phase
11 gives the round4 kernels' ``sel1`` and ``blend_par3`` chains beside
their bounds (the chain floor: iterations x these cycles over the SM
clock).
"""

from __future__ import annotations

import re

ALU = 4       # cycles: IMAD, IADD3, LOP3, IMNMX, LEA, SHF, ISETP, SEL, ...
LATENCY = {"LDS": 30, "LDSM": 30, "LD": 400, "LDG": 400, "LDL": 400}
NO_DEST = ("ST", "STS", "STG", "STL", "BRA", "EXIT", "BAR", "RED", "ATOM",
           "BSSY", "BSYNC", "WARPSYNC", "NOP", "RET", "CALL", "LDGSTS",
           "DEPBAR", "MEMBAR", "ERRBAR", "CCTL", "YIELD")
_REG = re.compile(r"\b(U?R\d+|U?P\d)\b")
_PRED = re.compile(r"^!?U?P(\d|T)$")


def _next(reg: str) -> str:
    """The register after ``reg`` (the high half of a 64-bit pair)."""
    head, num = re.match(r"(U?R)(\d+)", reg).groups()
    return f"{head}{int(num) + 1}"


def _regs(operand: str) -> list:
    """The registers an operand names (``R2.64`` names its pair)."""
    out = []
    for m in _REG.finditer(operand):
        out.append(m.group(1))
        if operand[m.end():].startswith(".64") and "R" in m.group(1):
            out.append(_next(m.group(1)))
    return out


def parse(ins: str) -> tuple:
    """(opcode, destinations, sources) of one SASS instruction: the first
    operand and the bare predicates right after it are destinations (a
    ``.WIDE`` or ``.64`` result names the next register too; ``PLOP3``
    writes two predicates), a guard predicate and every other register
    are sources."""
    srcs = []
    ins = ins.strip().rstrip(";")
    if ins.startswith("@"):
        guard, ins = ins.split(None, 1)
        srcs += _regs(guard)
    op, _, rest = ins.partition(" ")
    ops = [o.strip() for o in rest.split(",")] if rest.strip() else []
    mods = op.split(".")
    dests = []
    if ops and mods[0] not in NO_DEST:
        dests = _regs(ops[0])
        if "WIDE" in mods or "64" in mods:
            dests += [_next(d) for d in dests if "R" in d]
        if mods[0] in ("PLOP3", "UPLOP3"):
            dests += _regs(ops[1])
            k = 2
        else:
            k = 1
            while k < len(ops) and _PRED.match(ops[k]):
                dests += _regs(ops[k])
                k += 1
        ops = ops[k:]
    for o in ops:
        srcs += _regs(o)
    return op, dests, srcs


OTHER_MEMORY = ("LD", "ST", "LDG", "STG", "LDGSTS", "LDL", "STL", "ATOM",
                "ATOMG", "RED")


def reads_shared(body) -> bool:
    """Whether a loop body loads from shared memory and touches no other
    memory (global, local or through a generic address)."""
    ops = [parse(i)[0].split(".")[0] for i in body]
    return "LDS" in ops and not any(o in OTHER_MEMORY for o in ops)


def latency(op: str) -> int:
    """The cycles after ``op`` issues until its destinations are ready."""
    return LATENCY.get(op.split(".")[0], ALU)


def loops(listing) -> list:
    """(first, last) address spans of the loops of a kernel: a backward
    branch's target to the branch."""
    spans = []
    for addr, ins in listing:
        m = re.search(r"\bBRA\s+`?\(?(0x[0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr:
            spans.append((int(m.group(1), 16), addr))
    return spans


def loop_body(listing, want) -> list:
    """The instructions of the innermost loop whose body ``want(body)``
    accepts (a list of instruction texts); [] when none does."""
    for lo, hi in sorted(loops(listing), key=lambda s: s[1] - s[0]):
        body = [ins for a, ins in listing if lo <= a <= hi]
        if want(body):
            return body
    return []


def chain_cycles(body, iterations: int = 64) -> float:
    """Cycles an iteration of ``body`` (instruction texts, in order) takes
    in the steady state of the in-order model above: the slope of the
    last instruction's issue cycle over the second half of
    ``iterations``."""
    ready: dict = {}
    t = 0
    marks = []
    for _ in range(iterations):
        for ins in body:
            op, dests, srcs = parse(ins)
            t = max([t + 1] + [ready.get(r, 0) for r in srcs])
            for d in dests:
                ready[d] = t + latency(op)
        marks.append(t)
    half = iterations // 2
    return (marks[-1] - marks[half - 1]) / (iterations - half)
