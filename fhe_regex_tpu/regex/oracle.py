"""Plaintext oracle for the reference regex dialect.

An independent evaluator of the reference dialect semantics (engine.rs:45-214
rules incl. quirks Q1/Q6-Q9/Q15: strict-> Between bounds, content-capped
repetition, bounds pruning before Optional/Repeated arms, prefix match over
all start positions) computes the expected 0/1 by direct boolean evaluation
— no circuit builder, LUTs, executor, or PBS involved.  It is the plain
reference every encrypted result is checked against (tests, chip_smoke.py).
"""

from fhe_regex_tpu.regex import parser as P
from fhe_regex_tpu.regex.parser import parse


class OracleBudgetExceeded(Exception):
    pass


def _oracle_branches(content: bytes, re: P.RegExpr, pos: int,
                     counter: list) -> list:
    """[(bool, next_pos)] — direct plaintext evaluation of one AST node at
    one position, following the reference's variant-expansion rules."""
    counter[0] += 1
    if counter[0] > 200_000:
        raise OracleBudgetExceeded
    L = len(content)
    if isinstance(re, P.SOF):
        return [(True, pos)] if pos == 0 else []
    if isinstance(re, P.EOF):
        return [(True, pos)] if pos == L else []
    if pos >= L:                       # bounds prune before all other arms (Q15)
        return []
    c = content[pos]
    if isinstance(re, P.Char):
        return [(c == re.c, pos + 1)]
    if isinstance(re, P.AnyChar):      # matches any byte, consumes one (Q6)
        return [(True, pos + 1)]
    if isinstance(re, P.Not):          # negate each sub-variant's bit (Q9)
        return [(not v, p)
                for v, p in _oracle_branches(content, re.not_re, pos, counter)]
    if isinstance(re, P.Either):
        return (_oracle_branches(content, re.l_re, pos, counter)
                + _oracle_branches(content, re.r_re, pos, counter))
    if isinstance(re, P.Between):      # lower bound is EXCLUSIVE (Q1)
        return [((c > re.frm) and (c <= re.to), pos + 1)]
    if isinstance(re, P.Range):
        return [(c in re.cs, pos + 1)]
    if isinstance(re, P.Repeated):     # content-capped counts (Q7)
        at_least = re.at_least if re.at_least is not None else 0
        at_most = re.at_most if re.at_most is not None else L - pos
        if at_least > at_most:
            return []
        groups = [
            [(True, pos)] if at_least == 0 else [],
            _oracle_branches(
                content, P.Seq(tuple([re.repeat_re] * max(1, at_least))),
                pos, counter),
        ]
        for _ in range(at_least + 1, at_most + 1):
            nxt = []
            for v, p in groups[-1]:
                for v2, p2 in _oracle_branches(content, re.repeat_re, p,
                                               counter):
                    nxt.append((v and v2, p2))
            groups.append(nxt)
        return [b for g in groups for b in g]
    if isinstance(re, P.Optional_):
        res = _oracle_branches(content, re.opt_re, pos, counter)
        res.append((True, pos))
        return res
    if isinstance(re, P.Seq):
        if not re.re_xs:
            raise ValueError("empty sequence")
        cont = _oracle_branches(content, re.re_xs[0], pos, counter)
        for re_x in re.re_xs[1:]:
            nxt = []
            for v, p in cont:
                for v2, p2 in _oracle_branches(content, re_x, p, counter):
                    nxt.append((v and v2, p2))
            cont = nxt
        return cont
    raise ValueError(f"unmatched regex variant: {re!r}")


def oracle_match(content: str, pattern: str) -> int:
    """Plaintext truth: OR over all start positions 0..len-1 (Q8) of all
    variant bits — 0 for empty content, matching the reference."""
    ast = parse(pattern)
    data = content.encode("ascii")
    counter = [0]
    for start in range(len(data)):
        for v, _ in _oracle_branches(data, ast, start, counter):
            if v:
                return 1
    return 0
