"""The load generator's client process: ``clients`` analysts in a closed
loop, sending the run's queries to ``POST /query`` over HTTP, each
query's statements one after another, in whole decks.

    python perfbench/client.py PLAN_JSON OUT_JSON

``PLAN_JSON`` holds ``{"port", "seconds", "clients", "deck", "queries":
[{"template", "statements": [...]}, ...]}``; the queries come in decks of
``deck``.  The window opens when the first client starts.  Each client
takes the next query of the sequence when its last one is answered.  The
first deck is always sent; a later one is started only while less than
``seconds`` have passed; every deck started is sent whole, so the
window's work is a whole number of decks, however the queries' times
fall.  A statement is waited for up to ``GRACE_S``.  ``OUT_JSON`` gets
one record per query sent: its index, template, times from the window's
opening (``t_send``, ``t_done``, seconds), whether every statement came
back with HTTP 200 (``ok``), and the decoded responses.

Only the standard library is imported: this process loads no part of the
program and no array library.
"""
from __future__ import annotations

import http.client
import json
import sys
import threading
import time

GRACE_S = 120.0


def post(port: int, body: bytes, timeout: float):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/query", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, json.loads(data)
    finally:
        conn.close()


def run(plan: dict) -> list:
    queries = plan["queries"]
    seconds = float(plan["seconds"])
    deck = int(plan["deck"])
    lock = threading.Lock()
    state = {"next": 0, "stop": False}
    records = []
    t0 = time.perf_counter()

    def take():
        with lock:
            i = state["next"]
            if state["stop"] or i >= len(queries):
                return None
            # queries are handed out in order, so once a deck is refused
            # every query of the decks before it has been taken
            if i and i % deck == 0 and \
                    time.perf_counter() - t0 >= seconds:
                state["stop"] = True
                return None
            state["next"] = i + 1
            return i

    def one(i: int):
        q = queries[i]
        t_send = time.perf_counter() - t0
        ok, responses = True, []
        for st in q["statements"]:
            try:
                status, resp = post(plan["port"], json.dumps(st).encode(),
                                    GRACE_S)
            except (OSError, ValueError, http.client.HTTPException) as exc:
                status, resp = None, {"error": repr(exc)}
            ok = ok and status == 200
            responses.append(resp)
            if not ok:
                break
        rec = {"i": i, "template": q["template"], "t_send": t_send,
               "t_done": time.perf_counter() - t0, "ok": ok,
               "responses": responses}
        with lock:
            records.append(rec)

    def client():
        while (i := take()) is not None:
            one(i)

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(int(plan["clients"]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with lock:
        return sorted(records, key=lambda r: r["i"])


def main(argv) -> int:
    plan_path, out_path = argv
    with open(plan_path) as f:
        plan = json.load(f)
    records = run(plan)
    with open(out_path, "w") as f:
        json.dump(records, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
