"""Count the SASS instructions of the wavefront kernel's fill loop and
traceback loop.

    python3 sass_fill.py [SRC.cu [fill=FIRST-LAST] [traceback=FIRST-LAST]]
                         [--out DIR]

Compiles SRC (default dada2_tpu_torch/csrc/nw_wavefront.cu) for sm_90a
into a cubin with line information (nvcc -cubin -lineinfo, the same
-O3 as the kernel's build), disassembles it with nvdisasm, and prints for
every kernel instantiation:
  - its registers and spills from `-Xptxas -v`;
  - for each region, fill and traceback, the SASS instructions
    attributed to its source lines (those between each `// ---- fill`
    marker and the next `// ---- end of fill` marker, likewise for
    `traceback`, or the lines given; an inlined helper's instructions
    count at their outermost call site where nvdisasm reports inlining);
  - each loop of the region (a backward branch with at least a third of
    its body on the region's lines; the out-of-line code after the
    kernel's exits left out): its body size in instructions and how many
    of them are shuffles (SHFL), shared loads and stores (LDS, STS), warp
    barriers (WARPSYNC, BAR) and DPX or min/max instructions (VIMNMX,
    VIADDMNMX, IMNMX); for a fill loop with shuffles, its instructions
    per diagonal (the wavefront kernel's fill shuffles once per row
    register and diagonal, WP / 32 registers; the batch aligner's register
    and wide bodies, nw_batch_reg_kernel and nw_batch_wide_kernel, once
    per diagonal, the wide body with one BAR per diagonal).
Needs nvcc and nvdisasm (CUDA toolkit), not a card. The cubin and the
disassembly are kept in DIR (default build/sass).
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
DEFAULT_SRC = os.path.join(ROOT, "dada2_tpu_torch", "csrc", "nw_wavefront.cu")
REGIONS = ("fill", "traceback")
KINDS = {"SHFL": ("SHFL",), "LDS": ("LDS",), "STS": ("STS",),
         "SYNC": ("WARPSYNC", "BAR"),
         "MNMX": ("VIMNMX", "VIADDMNMX", "IMNMX", "VIMNMX3")}


def tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", name)


def marked_lines(src: str, name: str):
    """[(first, last)] line ranges between the markers of a region."""
    ranges, first = [], None
    for k, x in enumerate(open(src).read().splitlines(), 1):
        if f"// ---- end of {name}" in x and first is not None:
            ranges.append((first, k))
            first = None
        elif f"// ---- {name}" in x:
            first = k
    return ranges


def demangle(names):
    filt = shutil.which("c++filt")
    if not filt or not names:
        return {n: n for n in names}
    out = subprocess.run([filt], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {
        n: n for n in names}


def parse(sass: str):
    """{function: [(address, opcode text, source line or None)]} and
    {function: {label: address}} from nvdisasm -g output."""
    funcs, labels = {}, {}
    cur, line, pending = None, None, []
    ins_re = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
    for raw in sass.splitlines():
        m = re.search(r"\.text\.([A-Za-z0-9_$.]+):\s*$", raw)
        if m:
            cur = m.group(1)
            funcs[cur], labels[cur], line, pending = [], {}, None, []
            continue
        if cur is None:
            continue
        if "//##" in raw:
            nums = re.findall(r"line (\d+)", raw)
            line = int(nums[-1]) if nums else None
            continue
        m = re.match(r"^\s*(\.L_[A-Za-z0-9_]+):", raw)
        if m:
            pending.append(m.group(1))
            continue
        m = ins_re.search(raw)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[cur][lab] = addr
            pending = []
            funcs[cur].append((addr, m.group(2).strip(), line))
    return funcs, labels


def opcode(text: str) -> str:
    text = re.sub(r"^@!?U?P\w+\s+", "", text)
    return text.split()[0] if text else ""


def report(src: str, regions, out_dir: str) -> int:
    os.makedirs(out_dir, exist_ok=True)
    tag = os.path.splitext(os.path.basename(src))[0]
    cubin = os.path.join(out_dir, f"{tag}.cubin")
    cmd = [tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-cubin", "-lineinfo", "-Xptxas", "-v",
           "-o", cubin, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        print(f"sass_fill: nvcc failed:\n{proc.stderr}", file=sys.stderr)
        return 1
    ptxas = {}
    cur = None
    for raw in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", raw)
        if m:
            cur = m.group(1)
            ptxas[cur] = []
        elif cur and ("registers" in raw or "spill" in raw):
            ptxas[cur].append(raw.split("info    :")[-1].strip())
    for flag in ("-gi", "-g"):  # with inlining information if it has it
        dis = subprocess.run([tool("nvdisasm"), flag, "-c", cubin],
                             capture_output=True, text=True)
        if dis.returncode == 0:
            break
    if dis.returncode != 0:
        print(f"sass_fill: nvdisasm failed: {dis.stderr}", file=sys.stderr)
        return 1
    with open(os.path.join(out_dir, f"{tag}.sass"), "w") as fh:
        fh.write(dis.stdout)
    funcs, labels = parse(dis.stdout)
    if not funcs:
        print("sass_fill: no kernel found in the disassembly",
              file=sys.stderr)
        return 1
    names = demangle(sorted(funcs))
    print(f"sass_fill: {src}; " + "; ".join(
        f"{name} lines " + ", ".join(f"{a}-{b}" for a, b in rng)
        for name, rng in regions.items()))

    def within(line, rng):
        return line is not None and any(a <= line <= b for a, b in rng)

    for fn in sorted(funcs, key=lambda f: names[f]):
        ins = funcs[fn]
        rpt = re.search(r"ILi(\d)E", fn)
        rpt = int(rpt.group(1)) if rpt else 1
        if "nw_batch_reg_kernel" in fn or "nw_batch_wide_kernel" in fn:
            rpt = 1  # one shuffle per diagonal
        print(f"{names[fn]}: {len(ins)} instructions; " + ", ".join(
            f"{sum(within(x[2], rng) for x in ins)} on the {name}'s lines"
            for name, rng in regions.items())
            + f"; ptxas: {'; '.join(ptxas.get(fn, []))}")
        addr_of = {a: k for k, (a, _, _) in enumerate(ins)}
        for k, (addr, text, _) in enumerate(ins):
            m = re.search(r"BRA\b.*`\((\.L_[A-Za-z0-9_]+)\)", text)
            if not m or m.group(1) not in labels[fn]:
                continue
            tgt = labels[fn][m.group(1)]
            if tgt >= addr or tgt not in addr_of:
                continue  # forward, or a branch to itself (a trap)
            body = ins[addr_of[tgt]: k + 1]
            ops = [opcode(t).split(".")[0] for _, t, _ in body]
            if "EXIT" in ops:
                continue
            counts = {key: sum(op in kind for op in ops)
                      for key, kind in KINDS.items()}
            for name, rng in regions.items():
                if 3 * sum(within(x[2], rng) for x in body) < len(body):
                    continue
                per = (f"; {len(body) * rpt / counts['SHFL']:.1f} per "
                       "diagonal" if name == "fill" and counts["SHFL"]
                       else "")
                print(f"  {name} loop at line {body[0][2]}: {len(body)} "
                      "instructions in its body; " + ", ".join(
                          f"{v} {key}" for key, v in counts.items()) + per)
    return 0


def main(argv) -> int:
    out_dir = os.path.join(ROOT, "build", "sass")
    if "--out" in argv:
        k = argv.index("--out")
        out_dir = argv[k + 1]
        argv = argv[:k] + argv[k + 2:]
    src = os.path.abspath(argv[0]) if argv else DEFAULT_SRC
    regions = {name: marked_lines(src, name) for name in REGIONS}
    for arg in argv[1:]:
        name, _, lines = arg.partition("=")
        if name not in REGIONS or "-" not in lines:
            print(f"sass_fill: expected REGION=FIRST-LAST with REGION in "
                  f"{REGIONS}, got {arg!r}", file=sys.stderr)
            return 2
        regions[name] = [tuple(int(x) for x in lines.split("-"))]
    return report(src, regions, out_dir)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
