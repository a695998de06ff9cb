"""The CPU oracle: the spec matcher over parsed VCF records
(counterpart of ``sbeacon_tpu/oracle``)."""

from .cpu_oracle import match_record, oracle_search

__all__ = ["match_record", "oracle_search"]
