"""Conversion day with the PyTorch port, end to end: fetch the reference's
tarball, preflight it, convert it into a weight pack, and run the mel golden
gate on the card.

Each step is also a standalone CLI:

    python -m vietvoice_tts_tpu_torch.models.download --preflight
    python -m vietvoice_tts_tpu_torch.models.convert models/model-bin.pt packs/v1
    python -m vietvoice_tts_tpu_torch.golden --onnx-tarball models/model-bin.pt --pack packs/v1

Conversion is host work (numpy); only the golden gate's torch side runs on
the card.
"""

import json
import sys

from vietvoice_tts_tpu_torch.models.convert import convert_reference_tarball
from vietvoice_tts_tpu_torch.models.download import ensure_model_downloaded
from vietvoice_tts_tpu_torch.models.preflight import preflight_report

# 1. Fetch (cached, resumable; ~GB from HuggingFace).
tarball = ensure_model_downloaded(dest="models/model-bin.pt")

# 2. Preflight: fails in seconds with a checklist instead of mid-conversion,
#    and names the attention kernel the card will serve the head shape with.
report = preflight_report(tarball)
print(json.dumps({"ok": report["ok"], "blockers": report["blockers"],
                  "attention_route": report["architecture"].get("attention_route")},
                 indent=2))
if not report["ok"]:
    sys.exit("preflight blocked — fix the listed blockers first")

# 3. Convert into a weight pack (auto-discovers the starter name map).
conv = convert_reference_tarball(tarball, "packs/v1")
if conv["weights"].get("unresolved"):
    sys.exit(f"unresolved leaves: {conv['weights']['unresolved'][:5]}")

# 4. Numerics gate: mel allclose (atol 1e-2) vs the ONNX graphs.
#    (Run as a subprocess/CLI in real life — it prints one JSON line.)
print("now run: python -m vietvoice_tts_tpu_torch.golden --onnx-tarball", tarball,
      "--pack packs/v1")
