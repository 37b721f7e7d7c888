"""paddle.distributed.utils (counterpart of
``paddle_tpu/distributed/utils.py``): the launcher's small helpers; the
machinery is ``distributed/launch.py``."""
import logging
import socket


def get_host_name_ip():
    host = socket.gethostname()
    try:
        ip = socket.gethostbyname(socket.getfqdn(host))
    except OSError:
        ip = "127.0.0.1"
    return host, ip


def get_logger(log_level=20, name="root"):
    logger = logging.getLogger(name)
    logger.setLevel(log_level)
    return logger
