"""The benchmark's plain reference: the reference engine's semantics in
plain NumPy and Python, written for judging the program's reports.

It imports nothing of the program under test and nothing of JAX. It reads
the same table file and function index the program reads and the same
FASTA text the program was handed, and writes the report the reference
engine (KmerGutsJava.java) would write:

- ``fasta``: the reference's FASTA reader (readFasta, :1132-1192);
- ``prepare``: 8-mer windows, protein mode and six-frame DNA mode
  (prepareQuery :1051-1074, addKmers :900-922, translate :320-343);
- ``table``: the SURVEY 2.1 table file and the function index;
- ``lookup``: the forward-only merge-join scan (:944-1034), literally and
  as a per-query probe that gives the same hits on any table whose scan
  never runs off its end;
- ``grouping``: the call state machine (gatherHits :457-514,
  processSetOfHits :385-455) and the OTU counter;
- ``annotate``: the three phases end to end, report text out.
"""
