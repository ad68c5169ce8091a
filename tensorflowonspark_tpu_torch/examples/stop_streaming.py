"""Stop a streaming cluster from outside its driver.

Counterpart of ``examples/utils/stop_streaming.py``: STOP to the
cluster's rendezvous server, which ends the driver's ``train_stream``
after the micro-batch in flight (and ``shutdown(ssc=)`` stops a
streaming context)::

    python -m tensorflowonspark_tpu_torch.examples.stop_streaming <host> <port>
"""

from __future__ import annotations

import argparse

from tensorflowonspark_tpu_torch import rendezvous


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("host", help="the rendezvous server's host")
    parser.add_argument("port", type=int,
                        help="the rendezvous server's port")
    ns = parser.parse_args(argv)
    client = rendezvous.Client((ns.host, ns.port))
    try:
        client.request_stop()
    finally:
        client.close()
    print(f"sent STOP to {ns.host}:{ns.port}")


if __name__ == "__main__":
    main()
