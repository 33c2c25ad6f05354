"""Native-source pass: stdlib static checks over the C/C++ extensions.

The wire decoder and the shm arena are the only code in the tree where a
missed check is a segfault or a silent heap corruption instead of a
traceback, and (unlike the Python tree) no interpreter-level tooling sees
them. This pass parses `_native/*.c` / `*.cpp` with a comment/string-
stripping brace scanner — no compiler needed — and checks three properties:

  C1 unchecked-alloc   the result of PyMem_Malloc / PyMem_Realloc / malloc
                       is used without a null check anywhere in the function
  C2 unchecked-length  memcpy/memmove/memset with a VARIABLE length operand
                       in a function that never validates that variable
                       (no bounds `if`, no r_need/w_reserve-style checker
                       call mentioning it) — the length-field-before-memcpy
                       class of decoder bug
  C3 leak-on-error     an error return (`return NULL` / `return -1`) while
                       a Python object acquired earlier in the function
                       (PyTuple_New, PyBytes_FromStringAndSize, hook call
                       results, ...) is still owned and never released on
                       any path (`Py_DECREF`/`Py_XDECREF`/`Py_XSETREF`,
                       `return var`, or a stealing SET_ITEM)

Heuristic by design (C3 is flow-insensitive per variable: one release
anywhere ends tracking), so occasional false positives go to the verify
allowlist with a justification — same contract as every rt-lint pass.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.devtools.astutil import Violation, make_key

# Functions returning a NEW Python reference the caller owns.
_NEW_REF_FNS = (
    "PyTuple_New", "PyList_New", "PyDict_New", "_PyDict_NewPresized",
    "PyBytes_FromStringAndSize", "PyUnicode_DecodeUTF8",
    "PyUnicode_FromString", "PyLong_FromLongLong", "PyLong_FromLong",
    "PyFloat_FromDouble", "PyObject_CallFunctionObjArgs",
    "PyObject_CallObject", "PyModule_Create", "decode_obj",
)
_ALLOC_FNS = ("PyMem_Malloc", "PyMem_Realloc", "malloc", "realloc", "calloc")
_RELEASE_RE = r"Py_DECREF|Py_XDECREF|Py_XSETREF|Py_SETREF"
# Calls that transfer ownership of their argument (stolen reference).
_STEAL_FNS = ("PyTuple_SET_ITEM", "PyList_SET_ITEM", "PyModule_AddObject")
# Checker helpers whose call constitutes a bounds validation of an operand.
_BOUND_CHECK_FNS = ("r_need", "w_reserve", "w_u32", "r_u32")

from ray_tpu_torch.devtools.verify import DEFAULT_NATIVE_DIR  # noqa: E402


def strip_comments_and_strings(src: str) -> str:
    """Blank out comments, string and char literals (newlines preserved so
    line numbers survive)."""
    out: List[str] = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c == "/" and i + 1 < n and src[i + 1] == "/":
            j = src.find("\n", i)
            j = n if j < 0 else j
            out.append(" " * (j - i))
            i = j
        elif c == "/" and i + 1 < n and src[i + 1] == "*":
            j = src.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append("".join(ch if ch == "\n" else " " for ch in src[i:j]))
            i = j
        elif c in "\"'":
            q = c
            j = i + 1
            while j < n:
                if src[j] == "\\":
                    j += 2
                    continue
                if src[j] == q:
                    j += 1
                    break
                j += 1
            out.append(q + " " * (j - i - 2) + (q if j <= n else ""))
            i = j
        else:
            out.append(c)
            i += 1
    return "".join(out)


_FUNC_NAME_RE = re.compile(r"(\w+)\s*\([^()]*(?:\([^()]*\)[^()]*)*\)\s*(?:const\s*)?$")


def extract_functions(src: str) -> List[Tuple[str, int, str]]:
    """[(name, start_line, body)] for every top-level function definition;
    descends into `namespace {...}` / `extern "C" {...}` blocks."""
    clean = strip_comments_and_strings(src)
    funcs: List[Tuple[str, int, str]] = []

    def scan(text: str, base_line: int) -> None:
        depth = 0
        seg_start = 0  # start of the current "header" segment
        i = 0
        n = len(text)
        while i < n:
            c = text[i]
            if c in ";}":
                if depth == 0:
                    seg_start = i + 1
            elif c == "{":
                if depth == 0:
                    header = text[seg_start:i].strip()
                    # find the matching close brace
                    d = 1
                    j = i + 1
                    while j < n and d:
                        if text[j] == "{":
                            d += 1
                        elif text[j] == "}":
                            d -= 1
                        j += 1
                    body = text[i + 1:j - 1]
                    line = base_line + text[:i].count("\n")
                    if ("namespace" in header or "extern" in header) and \
                            "(" not in header:
                        scan_inner_base = base_line + text[:i + 1].count("\n")
                        scan(body, scan_inner_base)
                    else:
                        m = _FUNC_NAME_RE.search(header)
                        if m and not header.rstrip().endswith("=") and \
                                not re.search(r"\b(struct|class|enum|union)\s+\w+$",
                                              header):
                            funcs.append((m.group(1), line, body))
                    seg_start = j
                    i = j
                    continue
                depth += 1
            i += 1

    scan(clean, 1)
    return funcs


_ASSIGN_RE = re.compile(
    r"((?:\w+(?:->|\.))*\w+)\s*=\s*(?:\([^)]*\)\s*)?(\w+)\s*\("
)
_RETURN_ERR_RE = re.compile(r"\breturn\s+(NULL|nullptr|-\s*\w+|-?\d+)\s*;")
_RETURN_VAR_RE = re.compile(r"\breturn\s+(\w+)\s*;")


def _statements(body: str):
    """Yield (offset, stmt) roughly per ';'/'{'/'}' boundary."""
    start = 0
    for i, c in enumerate(body):
        if c in ";{}":
            stmt = body[start:i + 1]
            if stmt.strip():
                yield start, stmt
            start = i + 1


def check_function(path: str, name: str, start_line: int, body: str
                   ) -> List[Violation]:
    violations: List[Violation] = []
    base = os.path.basename(path)

    def line_of(off: int) -> int:
        return start_line + body[:off].count("\n")

    # --- C1: unchecked allocations -------------------------------------
    for m in _ASSIGN_RE.finditer(body):
        var, fn = m.group(1), m.group(2)
        if fn not in _ALLOC_FNS:
            continue
        checked = re.search(
            rf"!\s*{re.escape(var)}\b|\b{re.escape(var)}\s*==\s*(NULL|nullptr|0)\b"
            rf"|\b(NULL|nullptr)\s*==\s*{re.escape(var)}\b",
            body,
        )
        if not checked:
            violations.append(Violation(
                "native", path, line_of(m.start()),
                make_key("native", base, name, f"alloc={var}", "unchecked"),
                f"{name}: result of {fn}() assigned to {var!r} is never "
                f"null-checked in this function",
            ))

    # --- C2: variable-length memcpy without a bounds check --------------
    for m in re.finditer(r"\b(memcpy|memmove|memset)\s*\(", body):
        # crude argument split of the top-level call
        j = m.end()
        d = 1
        while j < len(body) and d:
            if body[j] == "(":
                d += 1
            elif body[j] == ")":
                d -= 1
            j += 1
        args = body[m.end():j - 1]
        parts, cur, d2 = [], "", 0
        for ch in args:
            if ch == "," and d2 == 0:
                parts.append(cur)
                cur = ""
                continue
            if ch in "([":
                d2 += 1
            elif ch in ")]":
                d2 -= 1
            cur += ch
        parts.append(cur)
        if len(parts) < 3:
            continue
        length = parts[-1].strip()
        if re.fullmatch(r"\d+|sizeof\s*\(.*\)", length):
            continue  # constant length: fine
        lvars = set(re.findall(r"\b([a-zA-Z_]\w*)\b", length)) - {
            "sizeof", "uint32_t", "uint64_t", "int64_t", "size_t", "Py_ssize_t",
        }
        ok = False
        prefix = body[:m.start()]
        for v in lvars:
            if re.search(rf"\b({'|'.join(_BOUND_CHECK_FNS)})\s*\([^;]*\b{re.escape(v)}\b", prefix) or \
                    re.search(rf"\bif\s*\([^)]*\b{re.escape(v)}\b[^)]*[<>]", prefix) or \
                    re.search(rf"\b{re.escape(v)}\s*=\s*[^;]*\b({'|'.join(_BOUND_CHECK_FNS)})", prefix):
                ok = True
        if lvars and not ok:
            violations.append(Violation(
                "native", path, line_of(m.start()),
                make_key("native", base, name, f"len={'/'.join(sorted(lvars))}", "memcpy"),
                f"{name}: {m.group(1)} length {length!r} is never bounds-"
                f"checked before the copy in this function",
            ))

    # --- C3: owned references leaked on error returns -------------------
    # Position-aware: at each `return NULL`/`return -1`, every object
    # acquired BEFORE it must have some release (DECREF / return var /
    # stealing SET_ITEM) at an EARLIER offset — "the success path returns
    # it at the end" does not excuse an early error exit. One release
    # exempts all later returns (conservative: correct error ladders
    # DECREF in their first error block).
    acquired: Dict[str, int] = {}
    first_release: Dict[str, int] = {}
    for m in _ASSIGN_RE.finditer(body):
        var, fn = m.group(1), m.group(2)
        if fn in _NEW_REF_FNS and var not in acquired:
            acquired[var] = m.start()
            pat = (
                rf"(?:{_RELEASE_RE})\s*\(\s*{re.escape(var)}\b"
                rf"|\breturn\s+{re.escape(var)}\s*;"
                rf"|\b(?:{'|'.join(_STEAL_FNS)})\s*\([^;]*\b{re.escape(var)}\s*\)"
            )
            rm = re.search(pat, body)
            if rm:
                first_release[var] = rm.start()
    if acquired:
        for off, stmt in _statements(body):
            rm = _RETURN_ERR_RE.search(stmt)
            if not rm:
                continue
            ret_off = off + rm.start()
            # The enclosing `if (...)` condition (if adjacent): a
            # `if (!var) return NULL;` is the var's OWN failure check.
            cond_m = None
            for cm in re.finditer(r"if\s*\(([^)]*(?:\([^)]*\)[^)]*)*)\)\s*(?:\{[^{}]*)?$",
                                  body[:ret_off]):
                cond_m = cm
            cond = cond_m.group(1) if cond_m and \
                ret_off - cond_m.end() < 200 else ""
            for var, acq_off in acquired.items():
                if acq_off >= ret_off:
                    continue  # acquired after this return
                if first_release.get(var, len(body) + 1) < ret_off:
                    continue  # released on some earlier path
                if re.search(rf"(?<![\w>]){re.escape(var)}\b", cond) and (
                        f"!{var}" in cond.replace(" ", "")
                        or re.search(rf"{re.escape(var)}\s*==\s*(NULL|nullptr|0)", cond)):
                    continue  # this return IS var's null-check
                violations.append(Violation(
                    "native", path, line_of(ret_off),
                    make_key("native", base, name, f"leak={var}",
                             f"ret@{line_of(ret_off)}"),
                    f"{name}: error return leaks owned reference {var!r} "
                    f"(acquired at line {line_of(acq_off)}, not released "
                    f"before this exit)",
                ))
    return violations


def run(pkg=None, native_dir: Optional[str] = None,
        sources: Optional[Dict[str, str]] = None) -> List[Violation]:
    """`pkg` is accepted (and ignored) for pass-signature uniformity."""
    violations: List[Violation] = []
    if sources is None:
        sources = {}
        d = native_dir or DEFAULT_NATIVE_DIR
        if os.path.isdir(d):
            for fname in sorted(os.listdir(d)):
                if fname.endswith((".c", ".cc", ".cpp")):
                    fpath = os.path.join(d, fname)
                    with open(fpath, "r", encoding="utf-8") as fh:
                        sources[fpath] = fh.read()
    for path, src in sources.items():
        for name, line, body in extract_functions(src):
            violations.extend(check_function(path, name, line, body))
    return violations
