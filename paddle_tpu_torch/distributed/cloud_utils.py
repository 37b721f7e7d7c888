"""paddle.distributed.cloud_utils (counterpart of
``paddle_tpu/distributed/cloud_utils.py``): readers over the PADDLE_*
contract the launcher writes."""
import os


def get_cluster_and_pod(args=None):
    raise RuntimeError(
        "cloud_utils.get_cluster_and_pod targets PaddleCloud's scheduler "
        "env; this build launches with distributed.launch / spawn over "
        "the PADDLE_* contract (distributed/launch.py)")


def get_trainers_num():
    return int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
