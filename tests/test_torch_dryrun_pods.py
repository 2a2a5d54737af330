"""The sharding-plan dry run on the two-pod mesh: the argument bytes of
every (architecture x shape) on 2x16x16 against the reference's shard
shapes (the 16x16 mesh's, and every spec, are in
``tests/test_torch_dryrun.py``)."""
from test_torch_dryrun import check_arg_bytes, port_arg_bytes, ref  # noqa


def test_arg_bytes_match_the_reference_on_two_pods(ref):  # noqa: F811
    check_arg_bytes(ref, port_arg_bytes("2x16x16"), "2x16x16")
