"""blaze-prof: render/convert continuous-profiling artifacts.

The engine's sampling profiler (runtime/profiler.py, on while
conf.profile_enabled) exports two artifacts per query into
conf.profile_export_dir — ``profile_<qid>.collapsed`` (flamegraph.pl
collapsed-stack text) and ``profile_<qid>.speedscope.json`` — and
embeds a ``profile_window`` block in hang/deadline flight dossiers.
This tool reads any of those and prints a hot-frames table, the
collapsed text, or a speedscope document (paste into speedscope.app):

    python -m blaze_tpu_torch.tools.blaze_prof PROF_DIR --query q123-1
    python -m blaze_tpu_torch.tools.blaze_prof PROF_DIR --list
    python -m blaze_tpu_torch.tools.blaze_prof profile_q123-1.collapsed \
        --format speedscope
    python -m blaze_tpu_torch.tools.blaze_prof dossier_..._hang_q1.json \
        --format collapsed

Collapsed lines lead with synthetic ``query:<id>;stage:<id>;exec:<id>``
frames, so flamegraph.pl groups the fleet-merged profile by query, then
stage, then executor. Frames of the engine name `blaze_tpu_torch.` modules
where the JAX package's name `blaze_tpu.` ones.

Like the port's other tools it takes `--device` (default `cuda`) and,
without a card and without `--device cpu`, refuses to start.
"""

import argparse
import json
import os
import re
import sys
from typing import Dict, List, Tuple

Pairs = List[Tuple[str, int]]

_COLLAPSED_RE = re.compile(r"^(?P<stack>.+) (?P<count>\d+)$")


def parse_collapsed(text: str) -> Pairs:
    """``frame;frame;frame count`` lines -> (stack, count) pairs.
    Malformed lines are skipped (the format is whitespace-hostile by
    construction: frames never contain spaces)."""
    pairs: Pairs = []
    for line in text.splitlines():
        m = _COLLAPSED_RE.match(line.strip())
        if m:
            pairs.append((m.group("stack"), int(m.group("count"))))
    return pairs


def window_pairs(window: dict) -> Pairs:
    """A flight dossier's profile_window block -> (stack, count)
    pairs with the same synthetic attribution prefix the engine's
    collapsed export uses."""
    pairs: Pairs = []
    qid = window.get("query_id") or "-"
    for s in window.get("stacks") or []:
        prefix = [f"query:{qid}"]
        if s.get("stage_id"):
            prefix.append(f"stage:{s['stage_id']}")
        if s.get("exec"):
            prefix.append(f"exec:{s['exec']}")
        pairs.append((";".join(prefix + [s.get("stack", "")]),
                      int(s.get("samples", 0))))
    return pairs


def hot_frames(pairs: Pairs, top: int = 10) -> List[dict]:
    """Leaf self-time ranking over (stack, count) pairs (attribution
    prefix frames never rank: a leaf is real code)."""
    agg: Dict[str, int] = {}
    total = 0
    for stack, n in pairs:
        leaf = stack.rsplit(";", 1)[-1]
        agg[leaf] = agg.get(leaf, 0) + n
        total += n
    if not total:
        return []
    ranked = sorted(agg.items(), key=lambda kv: (-kv[1], kv[0]))[:top]
    return [{"frame": f, "samples": n,
             "pct": round(100.0 * n / total, 1)} for f, n in ranked]


def to_collapsed(pairs: Pairs) -> str:
    return "".join(f"{stack} {n}\n" for stack, n in pairs)


def to_speedscope(pairs: Pairs, name: str = "blaze profile") -> dict:
    from blaze_tpu_torch.runtime.profiler import stacks_to_speedscope

    return stacks_to_speedscope(pairs, name=name)


def load_pairs(source: str, query: str = "") -> Tuple[Pairs, str]:
    """Resolve SOURCE (export dir / .collapsed file / dossier or
    speedscope .json) into (pairs, display name)."""
    if os.path.isdir(source):
        names = sorted(n for n in os.listdir(source)
                       if n.startswith("profile_")
                       and n.endswith(".collapsed"))
        if query:
            names = [n for n in names
                     if n == f"profile_{query}.collapsed"]
        if not names:
            raise SystemExit(f"no profile_*.collapsed under {source}"
                             + (f" for query {query!r}" if query else ""))
        pairs: Pairs = []
        for n in names:
            with open(os.path.join(source, n), encoding="utf-8") as f:
                pairs.extend(parse_collapsed(f.read()))
        return pairs, query or f"{len(names)} queries"
    with open(source, encoding="utf-8") as f:
        text = f.read()
    if source.endswith(".json"):
        doc = json.loads(text)
        if isinstance(doc.get("profile_window"), dict):  # flight dossier
            win = doc["profile_window"]
            return window_pairs(win), str(win.get("query_id") or source)
        if "profiles" in doc and "shared" in doc:  # speedscope passthru
            frames = [fr.get("name", "?")
                      for fr in doc["shared"].get("frames", [])]
            prof = (doc.get("profiles") or [{}])[0]
            pairs = []
            for ixs, w in zip(prof.get("samples") or [],
                              prof.get("weights") or []):
                pairs.append((";".join(frames[i] for i in ixs), int(w)))
            return pairs, str(doc.get("name") or source)
        raise SystemExit(f"{source}: json carries no profile_window "
                         f"and is not a speedscope document")
    return parse_collapsed(text), os.path.basename(source)


def list_queries(source: str) -> List[str]:
    if not os.path.isdir(source):
        raise SystemExit("--list needs an export dir")
    out = []
    for n in sorted(os.listdir(source)):
        if n.startswith("profile_") and n.endswith(".collapsed"):
            out.append(n[len("profile_"):-len(".collapsed")])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render/convert blaze continuous-profiling artifacts")
    ap.add_argument("source", help="export dir, .collapsed file, flight "
                                   "dossier .json or speedscope .json")
    ap.add_argument("--query", default="", help="restrict an export dir "
                                                "to one query id")
    ap.add_argument("--format", default="top",
                    choices=("top", "collapsed", "speedscope"))
    ap.add_argument("--top", type=int, default=10,
                    help="rows in the hot-frames table")
    ap.add_argument("--out", default="", help="write here instead of "
                                              "stdout")
    ap.add_argument("--list", action="store_true",
                    help="list query ids present in an export dir")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine whose profiles these "
                         "are (default: the CUDA card; --device cpu on "
                         "the host)")
    args = ap.parse_args(argv)
    from blaze_tpu_torch.tools import refuse_device

    if refuse_device("blaze_prof", args.device):
        return 2

    if args.list:
        for qid in list_queries(args.source):
            print(qid)
        return 0

    pairs, name = load_pairs(args.source, args.query)
    if args.format == "collapsed":
        text = to_collapsed(pairs)
    elif args.format == "speedscope":
        text = json.dumps(to_speedscope(pairs, name=f"blaze {name}"),
                          indent=1)
    else:
        total = sum(n for _, n in pairs)
        rows = hot_frames(pairs, top=args.top)
        head = f"{name}: {total} samples, {len(pairs)} distinct stacks"
        body = [f"  {r['frame']:<48} {r['samples']:>8}  {r['pct']:>5.1f}%"
                for r in rows]
        text = "\n".join([head] + body) + "\n"
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
