"""Minimal XML helpers for the S3 REST dialect.

Rendering is string-building with escaping (the response schemas are
small and fixed); parsing uses the stdlib ElementTree with namespaces
stripped, because real S3 clients send ``xmlns=`` on every request body
and the gateway must not care.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

XML_DECL = '<?xml version="1.0" encoding="UTF-8"?>\n'
S3_NS = "http://s3.amazonaws.com/doc/2006-03-01/"


def esc(value) -> str:
    s = str(value)
    return (
        s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
        .replace('"', "&quot;")
    )


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def parse(body: bytes) -> ET.Element | None:
    """Parse an XML body, namespaces stripped; None on malformed
    input (callers answer MalformedXML)."""
    try:
        root = ET.fromstring(body)
    except ET.ParseError:
        return None
    for el in root.iter():
        el.tag = _strip_ns(el.tag)
    return root


def parse_complete_multipart(body: bytes) -> list[tuple[int, str]] | None:
    """CompleteMultipartUpload body -> [(part_number, etag)] sorted by
    part number; None on malformed XML / missing fields."""
    root = parse(body)
    if root is None or root.tag != "CompleteMultipartUpload":
        return None
    parts: list[tuple[int, str]] = []
    for part in root.findall("Part"):
        num = part.findtext("PartNumber")
        etag = part.findtext("ETag") or ""
        try:
            parts.append((int(num), etag.strip().strip('"')))
        except (TypeError, ValueError):
            return None
    parts.sort(key=lambda p: p[0])
    return parts


def parse_lifecycle(body: bytes) -> dict | None:
    """LifecycleConfiguration body -> {"demote_after_s", "enabled"}.

    The S3 schema's ``<Transition><Days>N</Days>`` expresses the
    demote age; a nonstandard ``<Seconds>`` sibling is honored for
    sub-day tuning (tests, aggressive tiering). The first Rule with a
    Transition wins; None = malformed / no transition rule."""
    root = parse(body)
    if root is None or root.tag != "LifecycleConfiguration":
        return None
    for rule in root.findall("Rule"):
        enabled = (rule.findtext("Status") or "Enabled").strip() == "Enabled"
        trans = rule.find("Transition")
        if trans is None:
            continue
        secs = trans.findtext("Seconds")
        days = trans.findtext("Days")
        try:
            if secs is not None:
                after = float(secs)
            elif days is not None:
                after = float(days) * 86400.0
            else:
                return None
        except ValueError:
            return None
        return {"demote_after_s": max(after, 0.0), "enabled": enabled}
    return None


def render_lifecycle(rule: dict) -> str:
    after = float(rule.get("demote_after_s", 0.0))
    status = "Enabled" if rule.get("enabled", True) else "Disabled"
    days = int(after // 86400)
    body = (
        f"{XML_DECL}<LifecycleConfiguration xmlns=\"{S3_NS}\">"
        f"<Rule><ID>tiering</ID><Status>{status}</Status>"
        f"<Transition><Days>{days}</Days><Seconds>{after:g}</Seconds>"
        f"<StorageClass>TAPE</StorageClass></Transition>"
        f"</Rule></LifecycleConfiguration>"
    )
    return body


def error_xml(code: str, message: str, resource: str = "") -> str:
    return (
        f"{XML_DECL}<Error><Code>{esc(code)}</Code>"
        f"<Message>{esc(message)}</Message>"
        f"<Resource>{esc(resource)}</Resource></Error>"
    )
