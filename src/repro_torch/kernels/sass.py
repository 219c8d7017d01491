"""Read a built kernel's machine code (SASS): the dependent chain of its
main loop.

    from repro_torch.kernels import sass
    text = sass.disassemble("queue_booking")          # needs cuobjdump
    body = sass.hottest_loop(sass.function(text, "queue_booking_kernelILi1E"))
    sass.chain(body), sass.alu_count(body), len(body)

``chain`` counts the instructions on the longest path of true
dependencies (a register or predicate written, then read) that one pass
of a loop adds to the next: the body is walked twice, every value that
enters it counted as ready at depth 0, and the deepest instruction of the
second walk less the deepest of the first is what one iteration adds.
That is the loop's recurrence, the part that no amount of dispatch width
hides.  An instruction under a guard also reads its destination (it may
leave it unchanged).  The parser knows only what the reading needs:
which operands an instruction writes and which it reads.
"""
from __future__ import annotations

import os
import re
import subprocess
from typing import Dict, List, Tuple

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_REG = re.compile(r"(?<![\w.])(!?)(U?R\d+|U?P\d+)(\.64|\.128)?(?![\w])")
# opcodes that write no register (and every store, ST*)
_NO_DEST = {"RED", "BRA", "BRX", "EXIT", "RET", "CALL", "BAR", "BSSY",
            "BSYNC", "WARPSYNC", "NOP", "MEMBAR", "DEPBAR", "ERRBAR", "CCTL",
            "YIELD", "JMP", "BPT", "FENCE", "ARRIVES"}
#: opcodes of the ALU pipe (compares, selects, min/max, logic, integer
#: adds and shifts), which takes a warp instruction every second cycle on
#: an SM partition (16 lanes; the FP32 pipe has 32)
ALU_OPS = frozenset({"FSETP", "FSEL", "FSET", "FMNMX", "ISETP", "ISET", "SEL",
                     "IMNMX", "VIMNMX", "VIADDMNMX", "LOP3", "PLOP3", "IADD3",
                     "VIADD", "SHF", "LEA", "PRMT", "MOV", "P2R", "R2P",
                     "IABS", "FLO", "POPC", "BREV"})
_TWO_PRED_DEST = ("FSETP", "ISETP", "DSETP", "HSETP2", "PSETP", "PLOP3",
                  "UISETP", "UPLOP3", "VSETP")


class Instr:
    """One SASS instruction: its address, opcode, and the registers and
    predicates it writes and reads."""

    def __init__(self, addr: int, text: str):
        self.addr, self.text = addr, text
        guard = None
        if text.startswith("@"):
            guard, text = text.split(None, 1)
        parts = text.split(None, 1)
        self.op = parts[0]
        ops = [o.strip() for o in parts[1].split(",")] if len(parts) > 1 \
            else []
        base = self.op.split(".")[0]
        if base in _NO_DEST or base.startswith("ST"):
            n_dest = 0
        elif base in _TWO_PRED_DEST or base == "SHFL":
            n_dest = 2
        else:
            n_dest = 1 if ops else 0
        wide = 4 if ".128" in self.op else 2 if (
            ".64" in self.op or ".WIDE" in self.op) else 1
        self.dests: List[str] = []
        for o in ops[:n_dest]:
            for _, name, suffix in _REG.findall(o):
                self.dests += _expand(name, suffix, wide if not
                                      name.startswith(("P", "UP")) else 1)
        self.srcs: List[str] = []
        for o in ops[n_dest:]:
            for _, name, suffix in _REG.findall(o):
                self.srcs += _expand(name, suffix, 1)
        if guard is not None:
            g = guard.lstrip("@!")
            if g not in ("PT", "UPT"):
                self.srcs.append(g)
            self.srcs += self.dests      # a skipped write keeps the old value
        self.target = None
        if base in ("BRA", "BRX", "JMP") and ops:
            m = re.search(r"0x([0-9a-f]+)", ops[-1])
            lab = re.search(r"\.L_x_\d+", ops[-1])
            self.target = int(m.group(1), 16) if m else (
                lab.group(0) if lab else None)


def _expand(name: str, suffix: str, wide: int) -> List[str]:
    n = {"": wide, ".64": 2, ".128": 4}[suffix or ""]
    prefix = "UR" if name.startswith("UR") else name[0] if \
        name[0] in "RP" else name[:2]
    num = int(re.sub(r"\D", "", name))
    return [f"{prefix}{num + i}" for i in range(n)]


def disassemble(stem: str) -> str:
    """``cuobjdump -sass`` of the library built from ``csrc/<stem>.cu``
    (built first if stale)."""
    from repro_torch.kernels import _build
    lib = _build.build_all()[stem]
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def function(text: str, name: str) -> List[Instr]:
    """The instructions of the one function whose (mangled) name holds
    ``name``."""
    found: Dict[str, List[Instr]] = {}
    current = None
    labels: Dict[str, int] = {}
    pending: List[str] = []            # labels that name the next address
    for line in text.splitlines():
        if "Function :" in line:
            current = line.split("Function :", 1)[1].strip()
            found[current] = []
            continue
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _LINE.search(line)
        if m and current is not None:
            ins = Instr(int(m.group(1), 16), m.group(2).strip())
            labels.update((name, ins.addr) for name in pending)
            pending.clear()
            found[current].append(ins)
    hits = [k for k in found if name in k]
    if len(hits) != 1:
        raise KeyError(f"{len(hits)} functions match {name!r}")
    body = found[hits[0]]
    for ins in body:
        if isinstance(ins.target, str):
            ins.target = labels.get(ins.target)
    return body


def loops(body: List[Instr]) -> List[Tuple[int, int]]:
    """(first, last) index of every loop: a branch back to an earlier
    address."""
    index = {ins.addr: i for i, ins in enumerate(body)}
    out = []
    for i, ins in enumerate(body):
        if isinstance(ins.target, int) and ins.target <= ins.addr \
                and ins.target in index:
            out.append((index[ins.target], i))
    return out


def hottest_loop(body: List[Instr]) -> List[Instr]:
    """The body of the loop with the most instructions."""
    first, last = max(loops(body), key=lambda fl: fl[1] - fl[0])
    return body[first:last + 1]


def alu_count(loop: List[Instr]) -> int:
    """Instructions of ``loop`` that run on the ALU pipe."""
    return sum(ins.op.split(".")[0] in ALU_OPS for ins in loop)


def chain(loop: List[Instr]) -> int:
    """Dependent instructions one iteration of ``loop`` adds to the
    longest chain (see the module's note)."""
    depth: Dict[str, int] = {}
    deepest = []
    for _ in range(2):
        top = 0
        for ins in loop:
            d = 1 + max((depth.get(s, 0) for s in ins.srcs), default=0)
            for r in ins.dests:
                if r not in ("RZ", "PT", "URZ", "UPT"):
                    depth[r] = d
            top = max(top, d)
        deepest.append(top)
    return deepest[1] - deepest[0]
