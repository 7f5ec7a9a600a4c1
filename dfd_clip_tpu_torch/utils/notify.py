"""Completion notification hook (the port's copy of
dfd_clip_tpu/utils/notify.py; reference src/tools/notify.py:6-13).

The JAX package reads its bot token and chat id from the environment
(API_TOKEN, CHAT_ID); the port reads no environment, so both come as
arguments, and without both the call is a no-op: nothing is sent anywhere.
"""

from __future__ import annotations

import json
import logging
import urllib.request
from typing import Optional


def send_to_telegram(message: str, token: Optional[str] = None,
                     chat_id: Optional[str] = None) -> None:
    if not token or not chat_id:
        return
    try:
        req = urllib.request.Request(
            f"https://api.telegram.org/bot{token}/sendMessage",
            data=json.dumps({"chat_id": chat_id, "text": message}).encode(),
            headers={"Content-Type": "application/json"},
        )
        urllib.request.urlopen(req, timeout=10)
    except OSError as e:  # notification is best-effort
        logging.warning("telegram notify failed: %s", e)
