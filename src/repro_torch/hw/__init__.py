"""The paper's hardware model: the thermometer-aware FPGA cost model
(``cost``), the Verilog emitter (``verilog``), its co-simulation against
the packed oracle (``cosim``) and the paper's tables (``report``).  Numpy
copies of the reference's ``repro.hw``; a frozen model whose arrays are
tensors on the card is brought to the host once."""

from .cost import (comparator_luts, popcount_tree, encoder_cost,
                   lut_layer_cost, popcount_cost, argmax_cost,
                   dwn_hw_report, HWReport, ComponentCost)
from .verilog import emit_dwn, well_formed
from .cosim import (CosimError, CosimParseError, CosimReport, RTLMismatch,
                    SimulatorError, emit_testbench, evaluate_netlist,
                    parse_netlist, simulator_available, verify_rtl)
from .report import (PAPER_TABLE1, PAPER_TABLE2, PAPER_TABLE3,
                     PAPER_BASELINES, compare_with_paper, ComparisonRow)
