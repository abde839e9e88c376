"""5G NR PUSCH configuration: Gold sequences, DMRS, MCS and PUSCH grid."""
