from .fasta import FastaError, FastaRecord, read_fasta, open_text_maybe_gz
from .function_index import load_function_index, write_function_index
from .kmer_table import (
    KmerTable, TableError, build_table, write_table, read_table,
    resolve_table_files, SLOT_DTYPE,
    TABLE_FILE, FUNCTION_INDEX_FILE,
)
