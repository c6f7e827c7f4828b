"""The client sends whole decks: a deck is started only while the window's
seconds last, and every deck started is sent to its end."""
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from perfbench import client


class Slow(BaseHTTPRequestHandler):
    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        time.sleep(0.02)
        body = json.dumps({"value": 1, "count": 1}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


@pytest.fixture
def port():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), Slow)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()


@pytest.mark.parametrize("clients,seconds", [(1, 0.0), (1, 0.15), (3, 0.15)])
def test_whole_decks(port, clients, seconds):
    deck = 5
    queries = [{"template": f"t{i % deck}",
                "statements": [{"select": {"sum": "m"}}] * (1 + i % 2)}
               for i in range(deck * 40)]
    recs = client.run({"port": port, "seconds": seconds, "clients": clients,
                       "deck": deck, "queries": queries})
    assert len(recs) % deck == 0 and len(recs) >= deck
    assert [r["i"] for r in recs] == list(range(len(recs)))
    assert all(r["ok"] and r["t_done"] >= r["t_send"] for r in recs)
    # no deck after the first starts once the seconds have passed
    starts = [r["t_send"] for r in recs[deck::deck]]
    assert all(t < seconds + 0.05 for t in starts)
    assert len(recs) < len(queries)
