"""The OCR character tables (a copy of ``simpleaicv_tpu/data/char_table.py``):
``reference_char_table()``, the reference's exact 12,111-character order
read from this package's own ``reference_char_table.txt.gz`` (a
byte-identical copy of the JAX package's), and ``final_char_table()``,
the deterministic generated superset (digits, upper and lower case, the
ASCII and CJK symbols, CJK Extension A, the URO block and 192
supplementary-plane characters). Index 0 stays the CTC blank in
``CTCTextLabelConverter``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List

__all__ = ["final_char_table", "reference_char_table", "ASCII_SYMBOLS",
           "CJK_SYMBOLS"]

_DIGITS = "0123456789"
_UPPER = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
_LOWER = "abcdefghijklmnopqrstuvwxyz"

ASCII_SYMBOLS = (" !\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")

# common full-width / math / arrow symbols the reference's 82-symbol block
# covers (final_char_table.py rows 3-10)
CJK_SYMBOLS = ("§±·×÷—‘’“”…‰※€℃℉←↑→↓∈∏∑√∝∞∩∫∮∽≈≌≠≤≥⊥□△▽◇☆、。《》【】￡￥の"
               "　，．；：？！（）〔〕〈〉「」『』〖〗")


_SUPPLEMENTARY_CJK = (
    "\U00020164" "\U00020676" "\U00020CD0" "\U0002139A" "\U000235CB" "\U00023C97" "\U00023C98" "\U00023E23"
    "\U000249DB" "\U00024A7D" "\U00024AC9" "\U00025562" "\U000255A8" "\U00025ED7" "\U00026221" "\U0002648D"
    "\U00026676" "\U0002677C" "\U00026B5C" "\U00026C21" "\U00027FF9" "\U00028408" "\U00028678" "\U00028695"
    "\U000287E0" "\U00028B49" "\U00028C47" "\U00028C4F" "\U00028C51" "\U00028C54" "\U00028E99" "\U00029F7E"
    "\U00029F83" "\U00029F8C" "\U0002A7DD" "\U0002A8FB" "\U0002A917" "\U0002AA30" "\U0002AA36" "\U0002AA58"
    "\U0002AFA2" "\U0002B127" "\U0002B128" "\U0002B137" "\U0002B138" "\U0002B1ED" "\U0002B300" "\U0002B363"
    "\U0002B36F" "\U0002B372" "\U0002B37D" "\U0002B404" "\U0002B410" "\U0002B413" "\U0002B461" "\U0002B4E7"
    "\U0002B4EF" "\U0002B4F6" "\U0002B4F9" "\U0002B50D" "\U0002B50E" "\U0002B536" "\U0002B5AE" "\U0002B5AF"
    "\U0002B5B3" "\U0002B5E7" "\U0002B5F4" "\U0002B61C" "\U0002B61D" "\U0002B626" "\U0002B627" "\U0002B628"
    "\U0002B62A" "\U0002B62C" "\U0002B695" "\U0002B696" "\U0002B6AD" "\U0002B6ED" "\U0002B7A9" "\U0002B7C5"
    "\U0002B7E6" "\U0002B7F9" "\U0002B7FC" "\U0002B806" "\U0002B80A" "\U0002B81C" "\U0002B8B8" "\U0002BAC7"
    "\U0002BB5F" "\U0002BB62" "\U0002BB7C" "\U0002BB83" "\U0002BC1B" "\U0002BD77" "\U0002BD87" "\U0002BDF7"
    "\U0002BE29" "\U0002C029" "\U0002C02A" "\U0002C0A9" "\U0002C0CA" "\U0002C1D5" "\U0002C1D9" "\U0002C1F9"
    "\U0002C27C" "\U0002C288" "\U0002C2A4" "\U0002C317" "\U0002C35B" "\U0002C361" "\U0002C364" "\U0002C488"
    "\U0002C494" "\U0002C497" "\U0002C542" "\U0002C613" "\U0002C618" "\U0002C621" "\U0002C629" "\U0002C62B"
    "\U0002C62C" "\U0002C62D" "\U0002C62F" "\U0002C642" "\U0002C64A" "\U0002C64B" "\U0002C72C" "\U0002C72F"
    "\U0002C79F" "\U0002C7C1" "\U0002C7FD" "\U0002C8D9" "\U0002C8DE" "\U0002C8E1" "\U0002C8F3" "\U0002C907"
    "\U0002C90A" "\U0002C91D" "\U0002CA02" "\U0002CA0E" "\U0002CA7D" "\U0002CAA9" "\U0002CB29" "\U0002CB2D"
    "\U0002CB2E" "\U0002CB31" "\U0002CB38" "\U0002CB39" "\U0002CB3B" "\U0002CB3F" "\U0002CB41" "\U0002CB4A"
    "\U0002CB4E" "\U0002CB5A" "\U0002CB5B" "\U0002CB64" "\U0002CB69" "\U0002CB6C" "\U0002CB6F" "\U0002CB73"
    "\U0002CB76" "\U0002CB78" "\U0002CB7C" "\U0002CBB1" "\U0002CBBF" "\U0002CBC0" "\U0002CBCE" "\U0002CC56"
    "\U0002CCF5" "\U0002CCF6" "\U0002CCFD" "\U0002CCFF" "\U0002CD02" "\U0002CD0A" "\U0002CD8B" "\U0002CD8D"
    "\U0002CD8F" "\U0002CD90" "\U0002CD9F" "\U0002CDA0" "\U0002CDA8" "\U0002CDAD" "\U0002CDAE" "\U0002CDD5"
    "\U0002CE18" "\U0002CE1A" "\U0002CE23" "\U0002CE26" "\U0002CE2A" "\U0002CE7C" "\U0002CE88" "\U0002CE93"
)


@lru_cache(maxsize=1)
def reference_char_table() -> List[str]:
    """The reference's EXACT 12,111-char ordering (index-identical to
    simpleAICV/text_recognition/char_sets/final_char_table.py), shipped as
    contract data (reference_char_table.txt.gz — one char per position,
    utf-8).  Use this for reference-recipe configs: the CTC head width and
    class indices then match reference checkpoints 1:1; the generated
    superset below (``final_char_table``) remains the default for new
    recipes where index stability across dataset subsets matters more."""
    import gzip
    import os
    path = os.path.join(os.path.dirname(__file__),
                        "reference_char_table.txt.gz")
    with gzip.open(path, "rb") as f:
        chars = list(f.read().decode("utf-8"))
    assert len(chars) == 12111, f"corrupt table: {len(chars)}"
    return chars


@lru_cache(maxsize=1)
def final_char_table() -> List[str]:
    chars: List[str] = []
    chars.extend(_DIGITS)
    chars.extend(_UPPER)
    chars.extend(_LOWER)
    chars.extend(ASCII_SYMBOLS)
    chars.extend(CJK_SYMBOLS)
    seen = set(chars)
    assert len(seen) == len(chars), "duplicate symbol in the explicit lists"
    # CJK Ext-A then the URO block, codepoint order (deterministic forever)
    chars.extend(chr(c) for c in range(0x3400, 0x4DC0))
    chars.extend(chr(c) for c in range(0x4E00, 0xA000))
    chars.extend(_SUPPLEMENTARY_CJK)
    return chars
