"""Push alerting.

Counterpart of ``retrieval_augmented_mds_tpu/obs/callbacks.py``, owned by
the port (a copy).

Replaces `TeamsCallback` (sotasum/lightning_model.py:39-89,
sotasum/pretrain.py:88-142): webhook cards on run start and crash, the
two events the training commands report. Uses stdlib urllib (pymsteams
not in the image); disabled cleanly when no webhook URL is configured or
the host has no egress.
"""

from __future__ import annotations

import json
import urllib.request

from .logging import fault_tolerant


class TeamsNotifier:
    def __init__(self, webhook_url: str | None = None, run_name: str = "run"):
        self.url = webhook_url
        self.run_name = run_name

    @fault_tolerant
    def _post(self, title: str, facts: dict | None = None):
        if not self.url:
            return
        card = {
            "@type": "MessageCard",
            "title": f"{self.run_name}: {title}",
            "text": title,
            "sections": [
                {"facts": [{"name": k, "value": str(v)}
                           for k, v in (facts or {}).items()]}
            ],
        }
        req = urllib.request.Request(
            self.url,
            data=json.dumps(card).encode(),
            headers={"Content-Type": "application/json"},
        )
        urllib.request.urlopen(req, timeout=5)

    def on_fit_start(self, config: dict | None = None):
        self._post("training started", config)

    def on_exception(self, exc: BaseException):
        self._post("training crashed", {"error": repr(exc)})
