"""Robust VLM output parsing: the audit decision waterfall.

A plain Python copy of ``emr2a_tpu/judge/parsers.py`` (the port imports
nothing of the JAX package); ``tests/test_torch_judge.py`` holds the two
equal on the same outputs. What follows is the original's description.

Semantics parity with the reference's parser family
(pipelines/step4_vlm_review/vlm_audit_module.py:366-649), with the
exact fallback order preserved:

1. thinking models: take the text after ``</think>`` and extract JSON;
2. JSON anywhere in the full text (fenced block → direct parse →
   ``raw_decode`` scan over "{" positions, later objects preferred);
3. regex mining of decision/confidence/neighbors from thinking prose;
4. keyword fallback over the raw text.

Every stage normalizes to {decision, confidence, cited_neighbors,
rationale} with synonym folding and confidence clamping.  Failed
parses default toward "abstain" — the safety-critical direction.
"""

from __future__ import annotations

import ast
import json
import logging
import re
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

_ACCEPT_WORDS = ("accept", "support", "agree", "yes")
_REJECT_WORDS = ("reject", "oppose", "disagree", "no", "incorrect")
_ABSTAIN_WORDS = ("abstain", "uncertain", "unknown", "unsure")


def strip_thinking(text: str) -> Optional[str]:
    """Content after a ``</think>`` tag, or None if absent."""
    if "</think>" not in text:
        return None
    return text.split("</think>", 1)[1].strip()


def extract_json_payload(raw_output: str) -> Optional[Dict]:
    """Find a JSON object: fenced block → whole-string parse →
    incremental ``raw_decode`` over the text (the model's final answer
    usually comes last, so the last object wins)."""
    if not raw_output:
        return None
    text = raw_output.strip()

    fenced = re.search(r"```(?:json)?\s*(.*?)\s*```", text,
                       re.DOTALL | re.IGNORECASE)
    if fenced:
        text = fenced.group(1).strip()

    def try_parse(candidate: str) -> Optional[Dict]:
        for loader in (json.loads, ast.literal_eval):
            try:
                obj = loader(candidate)
                if isinstance(obj, dict):
                    return obj
            except Exception:
                continue
        return None

    if text.startswith("{") and text.endswith("}"):
        obj = try_parse(text)
        if obj is not None:
            return obj

    # Scan for embedded objects with the stdlib's incremental decoder:
    # ``raw_decode`` at each "{" yields the object and where it ends,
    # so string escapes / nested braces are the decoder's problem, not
    # ours.  Later objects are preferred (the model's final answer
    # usually comes last).
    decoder = json.JSONDecoder()
    found: List[Dict] = []
    pos = text.find("{")
    while pos != -1:
        try:
            obj, end = decoder.raw_decode(text, pos)
        except ValueError:
            pos = text.find("{", pos + 1)
            continue
        if isinstance(obj, dict):
            found.append(obj)
        pos = text.find("{", max(end, pos + 1))
    if found:
        return found[-1]

    # Python-literal dicts (single quotes) embedded in prose: collect
    # balanced top-level {...} spans in ONE linear pass (a plain depth
    # counter — a brace inside a quoted value just makes that span fail
    # literal_eval, which is the safe direction for a last-resort
    # stage) and evaluate them right-to-left so later objects still
    # win.  Growing every (open, close) window instead is quadratic in
    # the brace count of a 2k-token thinking dump.
    spans = []
    depth = 0
    start = -1
    for i, ch in enumerate(text):
        if ch == "{":
            if depth == 0:
                start = i
            depth += 1
        elif ch == "}" and depth:
            depth -= 1
            if depth == 0:
                spans.append((start, i + 1))
    for s, e in reversed(spans):
        try:
            obj = ast.literal_eval(text[s:e])
        except (ValueError, SyntaxError, MemoryError, RecursionError):
            continue
        if isinstance(obj, dict):
            return obj
    return None


def normalize_decision(raw: str) -> str:
    raw = (raw or "").lower().strip()
    if raw in _ACCEPT_WORDS:
        return "accept"
    if raw in _REJECT_WORDS:
        return "reject"
    if raw in _ABSTAIN_WORDS:
        return "abstain"
    return "abstain"  # ambiguity defaults to the safe direction


def normalize_confidence(value) -> float:
    if isinstance(value, str):
        m = re.search(r"[0-9]+(?:\.[0-9]+)?", value)
        value = float(m.group(0)) if m else 0.5
    try:
        value = float(value)
    except (TypeError, ValueError):
        value = 0.5
    return max(0.0, min(1.0, value))


def parse_cited_neighbors(value) -> List[int]:
    if isinstance(value, str):
        return [int(x) for x in re.findall(r"\d+", value)]
    if isinstance(value, (list, tuple)):
        out = []
        for v in value:
            try:
                out.append(int(v))
            except (TypeError, ValueError):
                continue
        return out
    return []


def parse_audit_payload(payload: Dict) -> Dict:
    """Normalize a structured payload
    (vlm_audit_module.py:585-622 semantics)."""
    return {
        "decision": normalize_decision(payload.get("decision", "")),
        "confidence": normalize_confidence(payload.get("confidence", 0.5)),
        "cited_neighbors": parse_cited_neighbors(
            payload.get("cited_neighbors", [])),
        "rationale": payload.get("rationale", ""),
    }


_DECISION_VERB = r"(?:decision\s*(?:should be|is|would be)|(?:choose|select|pick)|will|should)\s*[\"']?"
_THINKING_PATTERNS = {
    "accept": re.compile(_DECISION_VERB + r"(accept|agree|correct)"),
    "reject": re.compile(_DECISION_VERB + r"(reject|disagree|incorrect)"),
    "abstain": re.compile(_DECISION_VERB + r"(abstain|uncertain|unsure)"),
}

_CONF_PATTERNS = [
    re.compile(r"confidence[:\s]+([0-9.]+)"),
    re.compile(r"([0-9.]+)\s*confidence"),
    re.compile(r"confidence\s*(?:of|is)\s*([0-9.]+)"),
]

_NEIGHBOR_PATTERNS = [
    re.compile(r"neighbor[s]?\s*\[?(\d+)\]?"),
    re.compile(r"case[s]?\s*(\d+)"),
    re.compile(r"\[(\d+)\]"),
]


def parse_thinking_output(text: str) -> Dict:
    """Mine a decision out of thinking prose
    (vlm_audit_module.py:411-519 semantics: explicit decision phrases,
    then confidence/uncertainty word heuristics, default abstain)."""
    lower = text.lower()

    decision = None
    for name in ("accept", "reject", "abstain"):
        if _THINKING_PATTERNS[name].search(lower):
            decision = name
            break

    if decision is None:
        if any(w in lower for w in ("confident", "clear", "obvious")):
            if any(w in lower for w in ("support", "agree", "correct", "match")):
                decision = "accept"
            elif any(w in lower for w in ("contradict", "disagree", "wrong",
                                          "mismatch")):
                decision = "reject"
        if decision is None and any(
                w in lower for w in ("uncertain", "unclear", "ambiguous",
                                     "difficult", "hard to tell")):
            decision = "abstain"
    if decision is None:
        decision = "abstain"

    confidence = 0.5
    for pattern in _CONF_PATTERNS:
        m = pattern.search(lower)
        if m:
            try:
                v = float(m.group(1))
            except ValueError:
                continue
            if 0 <= v <= 1:
                confidence = v
                break
            if 0 <= v <= 100:
                confidence = v / 100.0
                break

    cited: List[int] = []
    for pattern in _NEIGHBOR_PATTERNS:
        cited.extend(int(x) for x in pattern.findall(lower))

    return {
        "decision": decision,
        "confidence": confidence,
        "cited_neighbors": sorted(set(cited)),
        "rationale": text[:300],
    }


def parse_audit_text(text: str) -> Dict:
    """Final keyword fallback (vlm_audit_module.py:624-649)."""
    lower = text.lower()
    if any(w in lower for w in ("accept", "support", "agree", "correct")):
        decision = "accept"
    elif any(w in lower for w in ("reject", "oppose", "disagree", "incorrect")):
        decision = "reject"
    else:
        decision = "abstain"

    m = re.search(r"confidence[:\s]+([0-9.]+)", lower)
    confidence = float(m.group(1)) if m else 0.5
    cited = [int(x) for x in re.findall(r"neighbor[s]?\s*\[?(\d+)\]?", lower)]
    return {
        "decision": decision,
        "confidence": confidence,
        "cited_neighbors": cited,
        "rationale": text[:200],
    }


def parse_audit_output(output_text: str) -> Optional[Dict]:
    """The full waterfall (vlm_audit_module.py:366-409)."""
    try:
        text = output_text.strip()

        after_think = strip_thinking(text)
        if after_think is not None:
            payload = extract_json_payload(after_think)
            if payload:
                return parse_audit_payload(payload)

        payload = extract_json_payload(text)
        if payload:
            return parse_audit_payload(payload)

        thinking = parse_thinking_output(text)
        if thinking:
            return thinking

        # Unreachable in practice: parse_thinking_output always returns
        # a dict (defaulting to abstain), exactly as in the reference
        # where _parse_audit_text is likewise shadowed
        # (vlm_audit_module.py:399-405).  Kept for API parity.
        return parse_audit_text(text)
    except Exception as e:  # never crash the audit loop on parse errors
        logger.error("Error parsing audit output: %s", e)
        return None
