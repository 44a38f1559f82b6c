"""Upload MIME universe, profiles, and magic-number validation.

Reference parity: backend/app/file_types.py (the
~230-type supported universe + safe/office/all-supported profiles) and
the magic-number checks in reference routes/uploads.py:71-105. The
universe is organized by INGESTION FAMILY rather than as a flat list:
this engine chunks anything it can decode to text, so what matters per
type is which extraction path it takes (plain decode, container, PDF
salvage), not which hosted service once accepted it.

Families:
- plain-text subtypes (``text/*``): documents, markup, data, source
  code, scientific formats — all utf-8 decoded and chunked directly;
- application types that are text in disguise (json, xml, scripts,
  latex) — same path;
- document containers (pdf, office, opendocument, epub) — magic-checked
  and routed through best-effort extractors.
"""

from __future__ import annotations

# -- text/* subtypes, grouped by what they are -------------------------------

_TEXT_DOCS = (
    "plain", "markdown", "html", "css", "enriched", "richtext", "rtf",
    "sgml", "troff", "vtt", "x-rst", "x-setext", "x-r-markdown",
    "prs.fallenstein.rst", "x-tex", "x-bibtex", "texmacs", "calendar",
    "x-vcalendar", "vcard", "uri-list", "rfc822-headers",
    "cache-manifest", "strings", "parameters", "example", "spdx",
    "x-sfv", "x-component", "vnd.ascii-art", "vnd.abc", "x-lilypond",
)
_TEXT_DATA = (
    "csv", "tsv", "tab-separated-values", "csv-schema", "xml",
    "xml-dtd", "xml-external-parsed-entity", "yaml", "n3", "turtle",
    "shaclc", "shex", "jcr-cnd", "dns", "cql", "cql-expression",
    "cql-identifier", "fhirpath", "hl7v2", "gff3", "x-gff3",
    "provenance-notation", "prs.lines.tag", "prs.prop.logic",
    "vnd.graphviz", "vnd.gml", "grammar-ref-list", "vnd.sosi",
    "vnd.familysearch.gedcom", "vnd.debian.copyright",
    "x-java-properties", "mizar",
)
_TEXT_CODE = (
    "javascript", "jsx", "tsx", "php", "wgsl", "x-asm", "x-c",
    "x-csrc", "x-chdr", "x-c++src", "x-c++hdr", "x-csharp", "x-cuda",
    "x-d", "x-dsrc", "x-diff", "x-emacs-lisp", "x-erlang", "x-go",
    "x-haskell", "x-literate-haskell", "x-java", "x-java-source",
    "x-kotlin", "x-lisp", "x-lua", "x-moc", "x-objcsrc", "x-pascal",
    "x-perl", "x-perl-script", "x-python", "x-python-script",
    "x-script.python", "x-ruby-script", "x-rust", "x-rsrc", "x-sass",
    "x-scss", "x-scala", "x-scheme", "x-sh", "x-csh", "x-tcl",
    "x-swift", "x-sql", "x-cassandra", "x-coffeescript", "x-boo",
    "x-vbasic", "x-siesta", "x-sos", "x-pcs-gcd",
)
_TEXT_NICHE = (
    # streaming/telecom registrations kept for reference parity — they
    # are valid IANA text/* types and decode as text
    "1d-interleaved-parityfec", "parityfec", "raptorfec", "flexfec",
    "ulpfec", "fwdred", "red", "rtx", "t140", "rtploopback",
    "rtp-enc-aescm128", "encaprtp", "vnd.dvb.subtitle",
    "vnd.fly", "vnd.fmi.flexstor", "vnd.hans", "vnd.hgl",
    "vnd.in3d.3dml", "vnd.in3d.spot", "vnd.latex-z",
    "vnd.motorola.reflex", "vnd.ms-mediapackage",
    "vnd.net2phone.commcenter.command", "vnd.radisys.msml-basic-layout",
    "vnd.senx.warpscript", "vnd.sun.j2me.app-descriptor",
    "vnd.trolltech.linguist", "vnd.wap.si", "vnd.wap.sl", "vnd.wap.wml",
    "vnd.wap.wmlscript", "vnd.esmertec.theme-descriptor",
    "vnd.curl", "vnd.a", "vnd.iptc.nitf", "vnd.iptc.newsml",
    "vnd.exchangeable", "vnd.ficlab.flt", "vnd.dmclientscript",
)

TEXT_TYPES = {f"text/{s}" for s in
              _TEXT_DOCS + _TEXT_DATA + _TEXT_CODE + _TEXT_NICHE}

# -- application/* types that decode as text ----------------------------------

_APP_TEXTUAL = (
    "json", "xml", "sql", "x-yaml", "ecmascript", "typescript", "dart",
    "vnd.dart", "x-latex", "x-tex", "x-php", "x-sh", "x-csh", "x-zsh",
    "x-shellscript", "x-powershell", "ms-java", "vnd.curl",
    "vnd.jupyter", "x-hwp", "x-hwp-v5", "vnd.ibm.secure-container",
)
APP_TEXT_TYPES = {f"application/{s}" for s in _APP_TEXTUAL}

# -- document containers (binary; magic-checked; extractor-routed) ------------

_OOXML = "application/vnd.openxmlformats-officedocument."
DOC_WORD = _OOXML + "wordprocessingml.document"
DOC_WORD_TPL = _OOXML + "wordprocessingml.template"
DOC_SHEET = _OOXML + "spreadsheetml.sheet"
DOC_SLIDES = _OOXML + "presentationml.presentation"

CONTAINER_TYPES = {
    "application/pdf", DOC_WORD, DOC_WORD_TPL, DOC_SHEET, DOC_SLIDES,
    "application/msword", "application/vnd.ms-excel",
    "application/vnd.oasis.opendocument.text",
    "application/rtf", "application/epub+zip", "application/zip",
}

ALL_SUPPORTED = TEXT_TYPES | APP_TEXT_TYPES | CONTAINER_TYPES

# -- upload profiles (reference file_types.py "Upload profiles") --------------

PROFILES: dict[str, set[str]] = {
    "safe": {"text/plain", "text/markdown", "text/csv",
             "text/tab-separated-values", "application/pdf",
             # kept from round 1's safe profile (tests + demo rely on
             # structured-text uploads being accepted by default)
             "text/html", "text/x-python", "application/json",
             "application/xml", "text/xml", "application/x-yaml"},
    "office": None,  # filled below
    "all-supported": set(ALL_SUPPORTED),
}
PROFILES["office"] = PROFILES["safe"] | {
    "application/msword", "application/vnd.ms-excel",
    "application/vnd.oasis.opendocument.text",
    DOC_WORD, DOC_WORD_TPL, DOC_SHEET, DOC_SLIDES,
}


def allowed_types(profile: str) -> set[str]:
    return PROFILES.get(profile, PROFILES["safe"])


# -- magic numbers -------------------------------------------------------------

_ZIPLIKE = (b"PK\x03\x04", b"PK\x05\x06", b"PK\x07\x08")
_MAGIC: dict[str, tuple[bytes, ...]] = {
    "application/pdf": (b"%PDF-",),
    "application/rtf": (b"{\\rtf",),
    "application/msword": (b"\xd0\xcf\x11\xe0",),  # OLE compound file
    "application/vnd.ms-excel": (b"\xd0\xcf\x11\xe0",),
    "application/zip": _ZIPLIKE,
    "application/epub+zip": _ZIPLIKE,
    "application/vnd.oasis.opendocument.text": _ZIPLIKE,
    DOC_WORD: _ZIPLIKE, DOC_WORD_TPL: _ZIPLIKE,
    DOC_SHEET: _ZIPLIKE, DOC_SLIDES: _ZIPLIKE,
}


def validate_magic(content_type: str, head: bytes) -> bool:
    """Reject files whose leading bytes contradict the declared type
    (reference: uploads.py:196-208). Types without magic pass."""
    magics = _MAGIC.get(content_type)
    if magics is None:
        return True
    return any(head.startswith(m) for m in magics)


def extract_text(data: bytes, content_type: str) -> str:
    """Best-effort text extraction for ingestion."""
    if content_type == "application/pdf":
        # Printable-ASCII salvage between PDF stream operators; a real
        # extractor is out of scope, but this keeps PDFs searchable.
        out = []
        token = bytearray()
        for b in data:
            if 32 <= b < 127 or b in (9, 10, 13):
                token.append(b)
            else:
                if len(token) >= 4:
                    out.append(token.decode("ascii", "ignore"))
                token.clear()
        if len(token) >= 4:
            out.append(token.decode("ascii", "ignore"))
        return " ".join(out)
    if content_type in CONTAINER_TYPES and data[:4] in _ZIPLIKE:
        return _extract_zip_text(data)
    return data.decode("utf-8", "replace")


def _extract_zip_text(data: bytes, *, max_total_bytes: int = 32 * 2**20
                      ) -> str:
    """Pull document text out of zip containers (OOXML/ODF/EPUB): decode
    the XML/HTML members and strip tags — dependency-free, good enough
    to make office uploads searchable. ``max_total_bytes`` bounds TOTAL
    decompressed text: a few-MB zip bomb can declare hundreds of
    highly-compressed 16 MB members, and accumulating them all would
    OOM the ingestion worker."""
    import io
    import re
    import zipfile
    out: list[str] = []
    budget = max_total_bytes
    try:
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            for info in z.infolist()[:200]:
                name = info.filename.lower()
                if not name.endswith((".xml", ".html", ".xhtml", ".txt")):
                    continue
                if info.file_size > budget:
                    continue
                raw = z.read(info).decode("utf-8", "replace")
                budget -= len(raw)
                text = re.sub(r"<[^>]+>", " ", raw)
                text = re.sub(r"\s+", " ", text).strip()
                if len(text) > 40:
                    out.append(text)
                if budget <= 0:
                    break
    except zipfile.BadZipFile:
        return data.decode("utf-8", "replace")
    return "\n\n".join(out)
