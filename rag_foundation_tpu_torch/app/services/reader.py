"""Span-extraction reader: pick the answer SPAN out of retrieved text.

The reference composes answers with a generative model
(the reference's backend/app/services/gemini_rag.py:517-551 streams
Gemini prose). Owning retrieval end-to-end means composition is ours;
this module is the deterministic extractive analog: given the question
and the ranked best-matching sentences from the retrieved chunks, score
candidate token spans and return the most likely short answer. On the
committed quality benchmark every answer string appears verbatim in the
corpus (benchmarks/quality/make_dataset.py), so span selection makes
exact-match a meaningful metric instead of structurally zero.

Design (no model, no global state — pure lexical features):

1. Classify the question's expected answer type from its interrogative
   pattern (NUMERIC / FREQUENCY / PERSON / NAME / PLACE / PHRASE).
2. Generate typed candidate spans inside each candidate sentence:
   number(+unit-run) spans, capitalized-run (proper noun) spans,
   frequency adverbs / "every N unit" spans, and the complement runs —
   maximal token runs that are NOT question-restatement (the answer is
   precisely the new information in the sentence).
3. Score = type match x trigger-word adjacency ("called X", "by X",
   "uses X") x proximity to question-term matches x edge quality,
   weighted by the sentence's own retrieval/overlap rank.
4. Trim edges: articles, stopwords, and question content tokens are
   stripped from span boundaries ("36 hexagonal segments" -> "36" when
   the question already says "hexagonal segments").
"""

from __future__ import annotations

import re
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# lexicons

_STOP = frozenset(
    "a an the is are was were be been being do does did to of in on at by "
    "for with from as and or but not no what which who whom whose when "
    "where why how this that these those it its if then than there here "
    "can could should would may might will shall has have had also very "
    "every each per about approximately roughly around under over above "
    "across within between after before during up down out into onto "
    "followed following called named respectively currently".split())

# words that may EXTEND a numeric span to its unit(s)
_UNIT_CONNECT = frozenset({"per", "square", "cubic", "of"})
_UNIT_SUFFIX = (
    "bytes", "byte", "watts", "watt", "volts", "volt", "bits", "bit",
    "grams", "gram", "meters", "meter", "metres", "metre", "seconds",
    "second", "minutes", "minute", "hours", "hour", "days", "day",
    "weeks", "week", "months", "month", "years", "year", "magnitudes",
    "arcseconds", "pixels", "pixel", "pascals", "pascal", "liters",
    "litres", "hertz", "degrees", "degree", "electrons", "stars",
    "kelvin", "percent", "%", "segments", "cores", "copies", "paths",
    "rows", "people", "persons", "operators", "fellows", "exposures",
    "programs", "institutions", "compressors", "terabytes", "petabytes",
    "megapixels", "millimagnitudes", "milliarcseconds", "milliseconds",
    "megawatts", "kilovolts", "gigabits", "megawatt-hours", "staff",
)
_SPELLED_NUM = frozenset(
    "one two three four five six seven eight nine ten eleven twelve "
    "thirteen fourteen fifteen sixteen seventeen eighteen nineteen "
    "twenty thirty forty fifty sixty seventy eighty ninety hundred "
    "thousand million billion trillion half quarter".split())
_FREQ_ADVERB = frozenset(
    "quarterly monthly weekly daily hourly annually yearly biennially "
    "nightly continuously continuous biweekly fortnightly".split())
_NAME_CONNECT = frozenset({"de", "del", "della", "di", "da", "van",
                           "von", "la", "le", "el", "al"})
_TITLE = frozenset({"dr.", "dr", "prof.", "prof", "mr.", "mrs.", "ms.",
                    "mx.", "eng."})
# a token just before the span that strongly marks an answer
_TRIGGER_AFTER = frozenset(
    "called named dubbed designated by uses use using with via at "
    "employs supplies provides chairs leads maintains administers "
    "manufactured operates exposes holds represents anchors monitors "
    "distributes serialized performs protects located".split())

# complement runs may keep interior stopwords ("humidity above 85
# percent") but never cross a coordination or a copula/auxiliary —
# those splice separate clauses
_RUN_SPLIT = frozenset(
    "or and is are was were be been being has have had will would "
    "can could must may might shall should does do did".split())

_NUM_RE = re.compile(r"^[~$]?\d[\d,]*(?:\.\d+)?(?:st|nd|rd|th)?$")
_WORD_RE = re.compile(r"[a-z0-9]+")

from rag_foundation_tpu_torch.app.services import textnorm  # noqa: E402

_stem = textnorm.stem


def _content_tokens(text: str) -> set[str]:
    return {_stem(t) for t in _WORD_RE.findall(text.lower())
            if t not in _STOP}


@dataclass
class _Tok:
    raw: str          # raw whitespace token, punctuation attached
    clean: str        # lowercased, stripped of edge punctuation
    stemmed: str
    cap: bool         # starts with an uppercase letter
    is_num: bool
    ends_clause: bool  # raw ends with , ; . : ) — span may not cross


def _tokenize(sentence: str) -> list[_Tok]:
    toks = []
    for raw in sentence.split():
        clean = raw.strip("\"'()[]{},.;:!?").lower()
        toks.append(_Tok(
            raw=raw,
            clean=clean,
            stemmed=_stem(clean),
            cap=bool(raw.lstrip("\"'([")[:1].isupper()),
            is_num=bool(_NUM_RE.match(clean)) or clean in _SPELLED_NUM
            or (("-" in clean) and all(
                p in _SPELLED_NUM for p in clean.split("-") if p)),
            ends_clause=raw.rstrip("\"')]")[-1:] in ",.;:!?",
        ))
    return toks


def _is_unit(clean: str) -> bool:
    if clean in _UNIT_CONNECT or clean in _SPELLED_NUM:
        return True
    return any(clean.endswith(s) for s in _UNIT_SUFFIX) or \
        bool(_NUM_RE.match(clean))


# ---------------------------------------------------------------------------
# question typing

NUMERIC, FREQUENCY, PERSON, NAME, PLACE, PHRASE, TIME, EXPLAIN = (
    "numeric", "frequency", "person", "name", "place", "phrase", "time",
    "explain")

_MEASURE_HINT = re.compile(
    r"\b(diameter|temperature|speed|rate|size|capacity|frequency|voltage"
    r"|duration|altitude|latency|bandwidth|accuracy|threshold|fraction"
    r"|percentage|budget|cost|draw|width|height|depth|length|distance"
    r"|airmass|megapixels|field of view|response time|shift|number"
    r"|specification|spec|tolerance)\b")

# measure hint -> the unit family its answer is expressed in. A numeric
# span whose unit belongs to the expected family is almost surely the
# answer; one from a DIFFERENT family almost surely is not ("eight
# days" is no altitude). Families are matched by unit-token suffix.
_UNIT_FAMILIES: dict[str, tuple[str, ...]] = {
    "length": ("meters", "meter", "metres", "metre", "kilometers",
               "kilometres", "feet", "foot", "miles", "millimeters"),
    "temperature": ("kelvin", "celsius", "fahrenheit"),
    "duration": ("seconds", "second", "minutes", "minute", "hours",
                 "hour", "days", "day", "weeks", "week", "months",
                 "month", "years", "year", "milliseconds",
                 "microseconds"),
    "data": ("bytes", "byte", "bits", "bit", "terabytes", "petabytes",
             "gigabytes", "megabytes", "gigabits", "megabits"),
    "power": ("watts", "watt", "megawatts", "kilowatts",
              "megawatt-hours", "kilowatt-hours"),
    "voltage": ("volts", "volt", "kilovolts"),
    "pressure": ("pascals", "pascal", "bar", "torr"),
    "angle": ("arcseconds", "arcsecond", "milliarcseconds", "mas",
              "degrees", "degree"),
    "photometry": ("magnitudes", "millimagnitudes", "mmag"),
    "percent": ("percent", "%"),
    "people": ("people", "persons", "operators", "staff", "fellows"),
}
_HINT_FAMILY: dict[str, tuple[str, ...]] = {
    "altitude": ("length",), "distance": ("length",),
    "depth": ("length",), "width": ("length",), "height": ("length",),
    "length": ("length",), "diameter": ("length",),
    "temperature": ("temperature",),
    "duration": ("duration",), "latency": ("duration",),
    "accuracy": ("photometry", "angle", "percent", "duration"),
    "bandwidth": ("data",), "voltage": ("voltage",),
    "draw": ("power",), "capacity": ("power", "data"),
    "fraction": ("percent",), "percentage": ("percent",),
}

# requirement/limit questions answer in limit-language sentences
_LIMIT_Q = re.compile(
    r"\b(maximum|minimum|allowed|limit|requirement|specification|spec"
    r"|tolerance|threshold)\b")
_LIMIT_S = re.compile(
    r"\b(must|exceed|below|least|most|accurate|accuracy|repeatable"
    r"|stay|cap|capped|never|within|allowed|limit)\b", re.I)
_NAME_HINT = re.compile(
    r"\b(name|codename|company|union|department|product|brand|service"
    r"|software|framework|instrument|system|algorithm|protocol|format"
    r"|standard|scheme|language|network|bus|lamp|laser|metric"
    r"|refrigerant|coating|series|country|city|identifier|acronym)\b")


def classify_question(question: str) -> str:
    q = question.lower().strip()
    if re.match(r"how\s+(often|frequently)", q):
        return FREQUENCY
    if re.match(r"how\s+(many|much|long|far|fast|quickly|deep|old|high"
                r"|soon|heavy|wide)", q):
        return NUMERIC
    if re.match(r"(how|why|what\s+happen)", q):
        # manner/cause — a short span is the wrong shape; the caller
        # falls back to sentence extraction
        return EXPLAIN
    if re.match(r"(at|to|from|by)?\s*what\s+(temperature|speed|rate|wind"
                r"|altitude|voltage)", q):
        return NUMERIC
    # clock-time only: "what time does X start" — NOT "what time
    # synchronization standard" (a NAME question about a standard)
    if re.match(r"(at\s+)?what\s+time\s+(do|does|did|is|are|will)", q):
        return NUMERIC
    if q.startswith("when"):
        return TIME
    if q.startswith("who") or "who is" in q or "who are" in q:
        return PERSON
    if q.startswith("where") or re.match(r"(in|at)\s+what\s+(city|country"
                                         r"|place|location)", q):
        return PLACE
    # both hint classes can fire ("codename for project number 873") —
    # the EARLIEST hint names the head noun, i.e. the answer type
    m_name = _NAME_HINT.search(q)
    m_meas = _MEASURE_HINT.search(q)
    if m_name and (not m_meas or m_name.start() < m_meas.start()):
        return NAME
    if m_meas:
        return NUMERIC
    if q.startswith("which"):
        return NAME
    return PHRASE


# ---------------------------------------------------------------------------
# candidate generation

@dataclass
class Span:
    lo: int           # token index, inclusive
    hi: int           # token index, exclusive
    kind: str         # numeric|capital|frequency|complement
    text: str = ""
    score: float = 0.0


def _clause_blocked(toks: list[_Tok], lo: int, hi: int) -> bool:
    """True when a clause boundary falls strictly inside [lo, hi)."""
    return any(toks[i].ends_clause and toks[i].clean not in _TITLE
               for i in range(lo, hi - 1))


def _numeric_spans(toks: list[_Tok], q_stems: set[str]) -> list[Span]:
    out = []
    for i, t in enumerate(toks):
        # the span must be NEW information: a number the question
        # itself contains ("project number 873") is restatement
        if not t.is_num or t.stemmed in q_stems:
            continue
        # extend through unit words not present in the question
        j = i + 1
        while (j < len(toks) and not toks[j - 1].ends_clause
               and not toks[j].cap
               and _is_unit(toks[j].clean)
               and toks[j].stemmed not in q_stems):
            j += 1
        # drop trailing connector ("per", "of" with nothing after)
        while j > i + 1 and toks[j - 1].clean in _UNIT_CONNECT:
            j -= 1
        out.append(Span(i, j, "numeric"))
        # "Class 4" / "Gaia DR4": a capitalized token (even a question
        # word) immediately before the number often belongs to the span
        if i > 0 and toks[i - 1].cap and not toks[i - 1].ends_clause:
            out.append(Span(i - 1, j, "numeric"))
    return out


def _capital_spans(toks: list[_Tok], q_stems: set[str]) -> list[Span]:
    out = []
    i = 0
    while i < len(toks):
        t = toks[i]
        start_ok = t.cap and (i > 0 or t.clean in _TITLE) \
            and t.stemmed not in q_stems and t.clean not in _STOP
        if not (t.cap and t.stemmed not in q_stems):
            i += 1
            continue
        j = i
        while j < len(toks):
            tj = toks[j]
            # capitalized continuation — question words allowed INSIDE a
            # run that started on new information ("Meridian Data
            # Release" when the question says "data release series")
            if tj.cap and (j == i or tj.stemmed not in q_stems
                           or toks[j - 1].cap):
                j += 1
                # a title's abbreviation dot is not a clause boundary
                if toks[j - 1].ends_clause \
                        and toks[j - 1].clean not in _TITLE:
                    break
                continue
            # lowercase connector glued only if a capital follows
            if (tj.clean in _NAME_CONNECT and j + 1 < len(toks)
                    and toks[j + 1].cap and not toks[j - 1].ends_clause):
                j += 2
                continue
            break
        # drop trailing question-word capitals ("DeepCam detectors" when
        # the question asked about detectors) but keep interior ones
        while j > i + 1 and toks[j - 1].stemmed in q_stems \
                and not toks[j - 2].cap:
            j -= 1
        if j > i and (start_ok or j - i > 1):
            out.append(Span(i, j, "capital"))
        i = max(j, i + 1)
    return out


def _frequency_spans(toks: list[_Tok], q_stems: set[str]) -> list[Span]:
    out = []
    for i, t in enumerate(toks):
        if t.clean in _FREQ_ADVERB:
            out.append(Span(i, i + 1, "frequency"))
        if t.clean in ("every", "each") and i + 1 < len(toks):
            j = i + 1
            while (j < len(toks) and j - i <= 3 and not toks[j].cap
                   and (toks[j].is_num or _is_unit(toks[j].clean)
                        or toks[j].stemmed not in q_stems
                        and toks[j].clean not in _STOP)
                   and not toks[j - 1].ends_clause):
                j += 1
            if j > i + 1:
                out.append(Span(i, j, "frequency"))
    return out


def _complement_spans(toks: list[_Tok], q_stems: set[str]) -> list[Span]:
    """Runs of tokens that are not question restatement: the maximal
    runs (stopwords allowed inside — "humidity above 85 percent"), the
    content sub-runs between stopwords ("simulated annealing" out of
    "...queue with simulated annealing over..."), coordination halves
    ("humidity above 85 percent" out of "... 85 percent or wind beyond
    18 meters per second"), and comma-joined enumerations
    ("cryogenics, computing, and dome drives")."""
    out = []
    runs: list[tuple[int, int]] = []
    i = 0
    while i < len(toks):
        if toks[i].stemmed in q_stems or toks[i].clean in _STOP:
            i += 1
            continue
        j = i
        while (j < len(toks) and toks[j].stemmed not in q_stems
               and (j == i or not toks[j - 1].ends_clause)):
            j += 1
        if j > i:
            runs.append((i, j))
            # coordination/copula split: each side of an interior
            # and/or/auxiliary is a complete candidate with its other
            # interior stopwords kept ("humidity above 85 percent" |
            # "wind beyond 18 meters per second"); the run CROSSING
            # the boundary is two clauses glued together ("Class 4 and
            # requires aircraft spotters", "544 is ZEBRA3808") and is
            # not a candidate
            coords = [b for b in range(i, j)
                      if toks[b].clean in _RUN_SPLIT]
            if coords:
                a = i
                for b in coords + [j]:
                    if b > a:
                        out.append(Span(a, b, "complement"))
                    a = b + 1
            else:
                out.append(Span(i, j, "complement"))
            # content sub-runs within [i, j)
            a = i
            while a < j:
                if toks[a].clean in _STOP:
                    a += 1
                    continue
                b = a
                while b < j and toks[b].clean not in _STOP \
                        and (b == a or not toks[b - 1].ends_clause):
                    b += 1
                if b > a and (a != i or b != j):
                    out.append(Span(a, b, "complement"))
                a = b + 1
        # resume AT j: when a clause boundary ended the run ("...,
        # computing, ..."), toks[j] starts the next run — skipping it
        # dropped every second comma-list member and broke enumeration
        # merging
        i = j
    # enumerations: merge runs split only by a comma (+ optional and/or)
    k = 0
    while k < len(runs):
        lo, hi = runs[k]
        m = k
        while m + 1 < len(runs):
            nlo, nhi = runs[m + 1]
            gap = toks[hi:nlo]
            if toks[hi - 1].raw.rstrip('"\')]').endswith(",") \
                    and nlo - hi <= 2 \
                    and all(t.clean in ("and", "or") or t.clean in _STOP
                            for t in gap):
                hi = nhi
                m += 1
            else:
                break
        if m > k:
            out.append(Span(lo, hi, "list"))
            first_num = next((x for x in range(lo, hi)
                              if toks[x].is_num), None)
            if first_num is not None and first_num > lo:
                out.append(Span(first_num, hi, "list"))
        k = max(m, k + 1)
    return out


# ---------------------------------------------------------------------------
# trimming + scoring

def _trim(toks: list[_Tok], lo: int, hi: int, q_stems: set[str],
          kind: str) -> tuple[int, int]:
    def keep(i: int) -> bool:
        t = toks[i]
        if (t.is_num and t.stemmed not in q_stems) \
                or t.clean in _FREQ_ADVERB:
            return True
        if t.cap and kind in ("capital", "numeric"):
            return True   # proper-noun tokens stay even if in question
            # (numeric: the "Class 4" leading-capital variant)
        if kind == "frequency" and t.clean in ("every", "each"):
            return True   # "every two years" — alias keeps the "every"
        return not (t.clean in _STOP or t.stemmed in q_stems)

    while lo < hi and not keep(lo):
        lo += 1
    while hi > lo and not keep(hi - 1):
        hi -= 1
    # leading verb heuristic: a lowercase -s/-ed token right after the
    # question's subject restatement ("loop USES liquid nitrogen",
    # "mirror CARRIES a protected silver") is the predicate verb, not
    # the answer; a participle after a stopword ("with SIMULATED
    # annealing") is adjectival and stays
    if (hi - lo >= 2 and not toks[lo].cap and not toks[lo].is_num
            and toks[lo].clean.endswith(("s", "ed"))
            and (toks[lo + 1].clean in _STOP
                 or (lo > 0 and toks[lo - 1].stemmed in q_stems))):
        lo += 1
        while lo < hi and not keep(lo):
            lo += 1
    if kind in ("complement", "list"):
        # brand-adjective drop: "redundant Sentinel-9 gauges" — the
        # leading lowercase modifier before a capitalized product name
        # is packaging, not answer
        if (hi - lo >= 2 and not toks[lo].cap and not toks[lo].is_num
                and toks[lo + 1].cap):
            lo += 1
        # leading adverb drop: "automatically at humidity above 85
        # percent" — the -ly adverb modifies the clause verb
        if (hi - lo >= 2 and not toks[lo].cap
                and toks[lo].clean.endswith("ly")
                and toks[lo].clean not in _FREQ_ADVERB):
            lo += 1
            while lo < hi and not keep(lo):
                lo += 1
        # trailing participle before a preposition: "gauges wired to
        # the PLC" — the "wired" belongs to the next clause
        if (hi - lo >= 2 and hi < len(toks)
                and toks[hi - 1].clean.endswith("ed")
                and len(toks[hi - 1].clean) >= 5
                and not toks[hi - 1].is_num
                and toks[hi].clean in ("to", "by", "with", "into",
                                       "onto", "for", "from")):
            hi -= 1
        # trailing locative connector: "control building next [to ...]"
        if (hi - lo >= 2 and hi < len(toks)
                and toks[hi - 1].clean in ("next", "adjacent", "close")
                and toks[hi].clean == "to"):
            hi -= 1
    return lo, hi


def _render(toks: list[_Tok], lo: int, hi: int) -> str:
    text = " ".join(t.raw for t in toks[lo:hi])
    text = text.strip("\"'([{").rstrip("\"')]},.;:!?")
    # "IPv6-only networking" style: a capitalized head with a hyphenated
    # lowercase modifier tail is the name alone ("IPv6")
    if hi - lo == 1:
        m = re.match(r"^([A-Z][A-Za-z0-9]*[0-9])-[a-z]+$", text)
        if m:
            return m.group(1)
    return text


_TYPE_PREF = {
    NUMERIC: {"numeric": 3.0, "frequency": 0.8, "capital": 0.3,
              "complement": 0.5, "list": 0.8},
    FREQUENCY: {"frequency": 3.0, "numeric": 1.2, "capital": 0.2,
                "complement": 0.5, "list": 1.0},
    PERSON: {"capital": 3.0, "numeric": 0.1, "frequency": 0.1,
             "complement": 0.5, "list": 0.3},
    NAME: {"capital": 2.4, "complement": 1.6, "numeric": 0.3,
           "frequency": 0.3, "list": 0.8},
    PLACE: {"capital": 2.0, "complement": 1.4, "numeric": 0.2,
            "frequency": 0.2, "list": 0.5},
    TIME: {"frequency": 1.5, "numeric": 1.5, "complement": 1.2,
           "capital": 0.8, "list": 1.0},
    PHRASE: {"complement": 1.6, "capital": 1.4, "numeric": 0.8,
             "frequency": 0.8, "list": 1.7},
}


@dataclass
class _QInfo:
    qtype: str
    families: tuple[str, ...] = ()     # expected unit families
    rate_q: bool = False               # answer should carry "per"
    limit_q: bool = False              # requirement/limit question
    plural: bool = False               # plural head noun -> enumeration
    count_q: bool = False              # "how many/much" question
    q_stems: object = None             # textnorm.StemSet of the question
    class_q: bool = False              # head noun is class/type/grade...
    subj_stems: frozenset = frozenset()  # "does the <subject> <verb>"


_LOCATIVE = frozenset({"at", "in", "inside", "near", "beside", "atop",
                       "under", "next", "within"})


def _span_families(toks: list[_Tok], lo: int, hi: int
                   ) -> set[str]:
    fams: set[str] = set()
    for t in toks[lo:hi]:
        for fam, units in _UNIT_FAMILIES.items():
            if t.clean in units:
                fams.add(fam)
    return fams


def _score_span(toks: list[_Tok], sp: Span, qinfo: _QInfo,
                q_positions: list[int], df: dict[str, int],
                n_sents: int) -> float:
    import math
    qtype = qinfo.qtype
    n = sp.hi - sp.lo
    if n == 0:
        return 0.0
    kind = sp.kind
    # a complement that is nothing but number+units answers a NUMERIC
    # question, not a NAME one ("4 megawatt-hours" is no storage
    # system). Requires an actual number (bare "hour" is not a
    # measurement) and a complete unit expression — a span the next
    # token would extend ("22 meters" cut from "22 meters per second")
    # is a truncation, not a reading.
    if kind == "complement" \
            and any(t.is_num for t in toks[sp.lo:sp.hi]) \
            and all(t.is_num or _is_unit(t.clean)
                    for t in toks[sp.lo:sp.hi]) \
            and not (sp.hi < len(toks)
                     and toks[sp.hi].clean in _UNIT_CONNECT
                     and not toks[sp.hi - 1].ends_clause):
        kind = "numeric"
    base = _TYPE_PREF[qtype].get(kind, 0.5)
    # an article/trigger immediately left of the trimmed span
    k = sp.lo - 1
    if k >= 0 and toks[k].clean in ("a", "an", "the"):
        k -= 1
    if qtype == PLACE and k >= 0 and toks[k].clean in _LOCATIVE \
            and not toks[k].ends_clause:
        base *= 2.0       # "at the base facility", "in the control building"
    elif qinfo.limit_q and k >= 0 and not toks[k].ends_clause \
            and toks[k].clean in ("below", "above", "exceed", "exceeds",
                                  "least", "most", "within", "to"):
        base *= 1.6       # "must stay below 0.02 ...", "repeatable to 10 ..."
    elif k >= 0 and toks[k].clean in _TRIGGER_AFTER \
            and not toks[k].ends_clause:
        base *= 1.5
        if toks[k].clean in ("called", "named", "dubbed"):
            base *= 1.5
    # a PLACE is never the modifier inside a noun compound ("18,000 CPU
    # cores" — the capitalized acronym modifies "cores")
    if qtype == PLACE and kind == "capital" and sp.hi < len(toks) \
            and not toks[sp.hi].cap and toks[sp.hi].clean not in _STOP \
            and not toks[sp.hi - 1].ends_clause:
        base *= 0.6
    # a bare number whose trimmed-off unit was the question's own noun
    # COUNTS that noun ("spread over 189 CCDs" for "what is the ...
    # specification for CCDs") — only a how-many question wants it
    if kind == "numeric" and n == 1 and not qinfo.count_q \
            and sp.hi < len(toks) and toks[sp.hi].stemmed \
            and not toks[sp.hi - 1].ends_clause \
            and toks[sp.hi].clean not in _STOP \
            and toks[sp.hi].stemmed in qinfo.q_stems:
        base *= 0.55
    # expected-unit matching: "altitude" answers in meters, not days
    if qinfo.families and kind in ("numeric", "complement", "list"):
        fams = _span_families(toks, sp.lo, sp.hi)
        if fams & set(qinfo.families):
            base *= 1.6
        elif fams:
            base *= 0.55
    # rate questions answer in compound per-units ("2 kelvin per hour")
    if qinfo.rate_q and kind == "numeric":
        if any(t.clean == "per" for t in toks[sp.lo:sp.hi]):
            base *= 1.5
        elif _span_families(toks, sp.lo, sp.hi):
            base *= 0.7
    # class/type/grade questions answer in designations ("Class 4"),
    # which the NAME type preference would otherwise bury
    if qinfo.class_q and kind == "numeric":
        base *= 5.0
    # plural head noun ("which systems") wants the full enumeration,
    # not one of its members
    if qinfo.plural:
        if kind == "list":
            base *= 2.5
        elif kind == "complement":
            base *= 0.6
    # "Class 4" style: the capitalized category token belongs in the
    # answer even when the question names the category
    if kind == "numeric" and toks[sp.lo].cap \
            and not toks[sp.lo].is_num:
        base *= 1.35
    # a lone token directly modifying the question's own noun is a
    # modifier, not an answer ("static ADDRESS assignment" for "what
    # addressing scheme" — the name is elsewhere in the sentence)
    if kind == "complement" and n == 1 and sp.hi < len(toks) \
            and toks[sp.hi].stemmed and not toks[sp.hi].cap \
            and toks[sp.hi].clean not in _STOP:
        base *= 0.6
    # an unmatched number inside a NAME/PHRASE complement marks the
    # qualified form ("humidity above 85 percent", not "humidity")
    if qtype in (NAME, PHRASE) and kind in ("complement", "list") \
            and n >= 3 and any(t.is_num for t in toks[sp.lo:sp.hi]):
        base *= 1.55
    # proximity to the nearest question-term match in the sentence
    if q_positions:
        d = min(min(abs(sp.lo - p), abs(sp.hi - 1 - p))
                for p in q_positions)
        base *= 1.0 + 1.0 / (1.0 + 0.5 * d)
    else:
        base *= 0.7
    # informativeness: rare tokens (low df across candidate sentences)
    # are answer-like; boilerplate that recurs everywhere is not
    content = [t for t in toks[sp.lo:sp.hi]
               if t.clean not in _STOP and t.clean]
    if content:
        idf = sum(math.log(1 + n_sents / df.get(t.stemmed, 0.5))
                  for t in content) / len(content)
        base *= 0.5 + 0.35 * idf
    # length prior: answers are short; enumerations run longer
    if kind == "complement":
        base *= 1.0 / (1.0 + 0.18 * max(0, n - 2))
    elif kind == "list":
        base *= 1.0 / (1.0 + 0.08 * max(0, n - 4))
    else:
        base *= 1.0 / (1.0 + 0.10 * max(0, n - 3))
    # person questions like two-token names
    if qtype == PERSON and kind == "capital" and n >= 2:
        base *= 1.3
    return base


@dataclass
class ReaderResult:
    span: str
    score: float
    sentence: str


def extract_answer_span(question: str,
                        ranked_sentences: list[tuple[str, float]],
                        ) -> ReaderResult | None:
    """Best answer span over ranked (sentence, weight) candidates.

    Returns None when no candidate scores positively — the caller then
    falls back to sentence-level extraction.
    """
    qtype = classify_question(question)
    if qtype == EXPLAIN:
        return None
    q_lower = question.lower()
    families: tuple[str, ...] = ()
    for hint, fams in _HINT_FAMILY.items():
        if re.search(rf"\b{hint}\b", q_lower):
            families = tuple(set(families) | set(fams))
    m_plural = re.match(r"(?:which|what)\s+([a-z-]+s)\b", q_lower)
    # fuzzy membership: token-in-q_stems uses textnorm.stems_match
    q_stems = textnorm.StemSet.from_text(question)
    qinfo = _QInfo(
        qtype=qtype,
        families=families,
        rate_q=bool(re.search(r"\brate\b", q_lower)),
        limit_q=bool(_LIMIT_Q.search(q_lower)),
        plural=bool(m_plural and m_plural.group(1) not in
                    ("is", "does", "was", "has", "its")),
        count_q=bool(re.match(r"how\s+(many|much)", q_lower)),
        q_stems=q_stems,
        # "what laser class", "what type of..." — the answer is a
        # category designation (number or Cap+number), not a name
        class_q=bool(re.search(
            r"\b(?:what|which)\s+(?:[a-z-]+\s+)?(class|type|category"
            r"|grade|level|tier|version)\b", q_lower)),
        # "does the nightly scheduler use" — the clause subject; the
        # answering sentence talks about THAT subject, a sentence
        # matching only the head noun talks about something else's
        # algorithm/format/etc.
        subj_stems=frozenset(
            _stem(w) for m2 in
            [re.search(r"\b(?:do|does|did|is|are)\s+(?:the|a|an)\s+"
                       r"([a-z][a-z -]+?)\s+"
                       r"(?:use|run|employ|have|take|hold|need|serve)",
                       q_lower)] if m2
            for w in m2.group(1).split() if w not in _STOP),
    )
    best: ReaderResult | None = None
    if not ranked_sentences:
        return None
    top_w = max(w for _, w in ranked_sentences) or 1.0
    # document frequency of stems over the candidate sentences — the
    # reader's only "corpus" statistics, no global state
    sent_toks = [_tokenize(s) for s, _ in ranked_sentences[:6]]
    df: dict[str, int] = {}
    for toks in sent_toks:
        for st in {t.stemmed for t in toks if t.clean not in _STOP}:
            df[st] = df.get(st, 0) + 1
    n_sents = max(1, len(sent_toks))
    for (sent, weight), toks in zip(ranked_sentences[:6], sent_toks):
        if not toks:
            continue
        q_positions = [i for i, t in enumerate(toks)
                       if t.stemmed in q_stems]
        cands: list[Span] = []
        cands += _numeric_spans(toks, q_stems)
        cands += _capital_spans(toks, q_stems)
        cands += _frequency_spans(toks, q_stems)
        cands += _complement_spans(toks, q_stems)
        sw = max(0.1, (weight / top_w) ** 1.5)
        # the sentence whose SUBJECT restates the question is the one
        # answering it ("The nightly scheduler optimizes ... with X"
        # over "Image differencing uses the Y algorithm")
        if any(p <= 2 for p in q_positions):
            sw *= 1.25
        # requirement questions answer in limit-language sentences
        # ("must never exceed", "must be repeatable to")
        if qinfo.limit_q and _LIMIT_S.search(sent):
            sw *= 1.4
        # clause-subject agreement: "what algorithm does the nightly
        # SCHEDULER use" — the sentence about the scheduler answers;
        # "Image differencing uses the ZOGY algorithm" talks about a
        # different subject's algorithm
        if qinfo.subj_stems:
            if any(t.stemmed in qinfo.subj_stems for t in toks):
                sw *= 1.3
            else:
                sw *= 0.75
        for sp in cands:
            lo, hi = _trim(toks, sp.lo, sp.hi, q_stems, sp.kind)
            if hi <= lo or (sp.kind != "list"
                            and _clause_blocked(toks, lo, hi)):
                continue
            sp2 = Span(lo, hi, sp.kind)
            s = _score_span(toks, sp2, qinfo, q_positions, df,
                            n_sents) * sw
            text = _render(toks, lo, hi)
            if not text or not _WORD_RE.search(text.lower()):
                continue
            if best is None or s > best.score:
                best = ReaderResult(span=text, score=s, sentence=sent)
    return best
