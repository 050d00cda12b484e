"""The instruction mix of the port's kernels as compiled for the card, from
``cuobjdump -sass`` of the kernel library (built first if missing).

    python3 scripts/sass_mix.py [name ...]

For every kernel whose mangled name holds one of the given substrings
(default: ``sep_rank_kernel`` and ``print_encode_kernel``) prints its
instruction count and opcode counts, then each loop of at least 48
instructions (a backward branch and its target): its address range, its
length and its counts of FFMA, shared loads (LDS), constant loads (LDC,
ULDC), global loads (LDG), SFU operations (MUFU), population counts (POPC),
integer-to-float conversions (I2F) and barriers, with the FFMA share. Needs the CUDA toolkit's ``cuobjdump``; the card is not used.
"""

from __future__ import annotations

import collections
import glob
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raw2film_tpu_torch.kernels import build as kb  # noqa: E402

INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
SHOWN = ("FFMA", "LDS", "LDC", "ULDC", "LDG", "MUFU", "POPC", "I2F", "BAR")


def main() -> int:
    names = sys.argv[1:] or ["sep_rank_kernel", "print_encode_kernel"]
    path = kb.build()
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    tool = tool if os.path.isfile(tool) else shutil.which("cuobjdump")
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True, check=True).stdout
    print(f"library {os.path.basename(path)} ({len(glob.glob(os.path.join(kb.BUILD_DIR, '*.so')))} in the build dir)")
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        if not any(n in name for n in names):
            continue
        code = [(int(a, 16), op, rest) for a, op, rest in INSTR.findall(block)]
        ops = collections.Counter(op.split(".")[0] for _, op, _ in code)
        print(f"\n{name}\n  {len(code)} instructions: {dict(ops.most_common(12))}")
        index = {a: i for i, (a, _, _) in enumerate(code)}
        for i, (a, op, rest) in enumerate(code):
            target = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
            if target is None or int(target.group(1), 16) >= a:
                continue
            start = index.get(int(target.group(1), 16))
            if start is None or i - start + 1 < 48:
                continue
            body = collections.Counter(o.split(".")[0] for _, o, _ in code[start:i + 1])
            n = i - start + 1
            mix = ", ".join(f"{k} {body[k]}" for k in SHOWN if body[k])
            print(f"  loop {code[start][0]:#x}-{a:#x}: {n} instructions, {mix}; FFMA {body['FFMA'] / n:.0%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
