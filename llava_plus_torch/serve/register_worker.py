"""Manually register a worker with the controller (ref
llava/serve/register_worker.py) — for workers behind NAT whose construction-
time registration could not reach the controller.

The port's own copy of ``llava_plus_tpu/serve/register_worker.py``.
"""

import argparse

import requests


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller-address", type=str, required=True)
    parser.add_argument("--worker-name", type=str, required=True)
    parser.add_argument("--check-heart-beat", action="store_true")
    args = parser.parse_args()

    url = args.controller_address + "/register_worker"
    data = {
        "worker_name": args.worker_name,
        "check_heart_beat": args.check_heart_beat,
        "worker_status": None,
    }
    r = requests.post(url, json=data)
    assert r.status_code == 200


if __name__ == "__main__":
    main()
