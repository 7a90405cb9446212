"""Restricted expression language for simulator formulas and rules.

Behavioral contract: urh/simulator/SimulatorExpressionParser.py (an AST
re-walked on every evaluation).  Re-architected compile-once: an
expression is validated against a declarative AST whitelist and turned
into a Python code object a single time (cached per expression text);
each evaluation executes that code object against a namespace of live
item proxies, so the hot simulation loop never re-parses.

Semantics of identifiers (``item<N>.<label>``):
* message labels read the last exchanged message's bits — as an
  MSB-first integer, or as ASCII when compared against a string;
* counter actions read their current value;
* trigger-command actions read their last return code via ``.rc``.
"""

from __future__ import annotations

import ast
import html

# allowed operator node types per expression kind
_FORMULA_OPS = frozenset((ast.Add, ast.Sub, ast.Mult, ast.Div, ast.BitOr,
                          ast.BitXor, ast.BitAnd, ast.LShift, ast.RShift,
                          ast.Invert, ast.UAdd, ast.USub))
_CONDITION_OPS = frozenset((ast.And, ast.Or, ast.Not, ast.Eq, ast.NotEq,
                            ast.Lt, ast.LtE, ast.Gt, ast.GtE))


def _fail(message, node):
    raise SyntaxError(message or "_invalid syntax",
                      ("", getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), ""))


class LabelValue:
    """Deferred message-label value with type-directed comparison:
    against a str it reads the label as ASCII, otherwise as an
    MSB-first integer (also used for arithmetic in formulas)."""

    __slots__ = ("_label",)

    def __init__(self, sim_label):
        self._label = sim_label

    def as_int(self) -> int:
        message = self._label.parent()
        start, end = message.get_label_range(self._label, 0, False)
        return int(message.plain_bits_str[start:end], 2)

    def as_str(self) -> str:
        message = self._label.parent()
        start, end = message.get_label_range(self._label, 2, False)
        return message.plain_ascii_str[start:end]

    def _view(self, other):
        return self.as_str() if isinstance(other, str) else self.as_int()

    def __eq__(self, other):
        return self._view(other) == _unwrap(other)

    def __ne__(self, other):
        return self._view(other) != _unwrap(other)

    def __lt__(self, other):
        return self._view(other) < _unwrap(other)

    def __le__(self, other):
        return self._view(other) <= _unwrap(other)

    def __gt__(self, other):
        return self._view(other) > _unwrap(other)

    def __ge__(self, other):
        return self._view(other) >= _unwrap(other)

    def __hash__(self):
        return hash(self.as_int())


def _unwrap(value):
    return value.as_int() if isinstance(value, LabelValue) else value


class _ItemProxy:
    """Namespace entry `itemN`; attribute access resolves the live item
    behind `itemN.<attr>` at evaluation time."""

    __slots__ = ("_config", "_name", "_numeric")

    def __init__(self, config, name: str, numeric: bool):
        self._config = config
        self._name = name
        self._numeric = numeric

    def __getattr__(self, attr):
        from urh_tpu_torch.sim.items import (SimulatorCounterAction,
                                       SimulatorProtocolLabel,
                                       SimulatorTriggerCommandAction)

        item = self._config.item_dict[self._name + "." + attr]
        if isinstance(item, SimulatorProtocolLabel):
            value = LabelValue(item)
            return value.as_int() if self._numeric else value
        if isinstance(item, SimulatorCounterAction):
            return item.value
        if isinstance(item, SimulatorTriggerCommandAction):
            return item.return_code
        raise AttributeError(attr)


class _LiveNamespace(dict):
    """Locals mapping for eval(): names spring into proxies on demand."""

    def __init__(self, config, numeric: bool):
        super().__init__()
        self._config = config
        self._numeric = numeric

    def __missing__(self, name):
        return _ItemProxy(self._config, name, self._numeric)


class SimulatorExpressionParser:
    formula_help = ("Operators: + - * / | ^ & << >> ~ ; literals: dec/hex/bin/oct; "
                    "example: item1.sequence_number + 1")
    rule_condition_help = ("Boolean: and/or/not; comparisons: == != < <= > >=; "
                           "example: item1.data == \"abc\"")

    def __init__(self, config):
        self.simulator_config = config
        self._code_cache: dict = {}

    # -- public API -----------------------------------------------------------

    def validate_expression(self, expr, is_formula=True):
        """(valid, help-or-error message, compiled handle)."""
        try:
            handle = self._compiled(expr, is_formula)
        except SyntaxError as err:
            caret = " " * (err.offset or 0) + "^"
            return False, ("<pre>" + html.escape(expr) + "<br/>" + caret
                           + "</pre>" + str(err)), None
        return True, (self.formula_help if is_formula
                      else self.rule_condition_help), handle

    def evaluate_formula(self, expr):
        return self.evaluate_node(self._compiled(expr, is_formula=True))

    def evaluate_condition(self, expr) -> bool:
        return bool(self.evaluate_node(self._compiled(expr, is_formula=False)))

    def evaluate_node(self, handle):
        """Execute a handle from validate_expression against live state."""
        code, is_formula = handle
        namespace = _LiveNamespace(self.simulator_config, numeric=is_formula)
        return eval(code, {"__builtins__": {}}, namespace)  # noqa: S307 — AST pre-validated

    def get_identifiers(self):
        return [name for name in self.simulator_config.item_dict
                if self.is_valid_identifier(name)]

    def is_valid_identifier(self, identifier: str) -> bool:
        from urh_tpu_torch.sim.items import (SimulatorCounterAction,
                                       SimulatorProtocolLabel,
                                       SimulatorTriggerCommandAction)

        item = self.simulator_config.item_dict.get(identifier)
        if isinstance(item, (SimulatorProtocolLabel, SimulatorCounterAction)):
            return True
        return (isinstance(item, SimulatorTriggerCommandAction)
                and identifier.endswith("rc"))

    # -- compilation ----------------------------------------------------------

    def _compiled(self, expr: str, is_formula: bool):
        key = (expr, is_formula)
        handle = self._code_cache.get(key)
        if handle is None:
            tree = ast.parse(expr, mode="eval")
            self._check(tree.body, is_formula)
            handle = (compile(tree, "<simulator>", "eval"), is_formula)
            self._code_cache[key] = handle
        return handle

    def _check(self, node, is_formula: bool):
        checker = (self._FORMULA_RULES if is_formula
                   else self._CONDITION_RULES).get(type(node))
        if checker is None:
            _fail("", node)
        checker(self, node, is_formula)

    # rule bodies -------------------------------------------------------------

    def _rule_constant(self, node, is_formula):
        ok_types = (int, float) if is_formula else (int, float, str)
        if not isinstance(node.value, ok_types):
            _fail("", node)

    def _rule_binop(self, node, is_formula):
        if type(node.op) not in _FORMULA_OPS:
            _fail("unknown operator", node)
        self._check(node.left, is_formula)
        self._check(node.right, is_formula)

    def _rule_unary(self, node, is_formula):
        allowed = _FORMULA_OPS if is_formula else _CONDITION_OPS
        if type(node.op) not in allowed:
            _fail("unknown operator", node)
        self._check(node.operand, is_formula)

    def _rule_boolop(self, node, is_formula):
        for value in node.values:
            self._check(value, is_formula)

    def _rule_compare(self, node, is_formula):
        if len(node.ops) != 1 or len(node.comparators) != 1:
            _fail("", node)
        if type(node.ops[0]) not in _CONDITION_OPS:
            _fail("unknown operator", node)
        left, right = node.left, node.comparators[0]
        if not isinstance(left, ast.Attribute):
            _fail("the left-hand side of a comparison must be a label identifier",
                  left)
        self._rule_attribute(left, is_formula)
        right_is_const = (isinstance(right, ast.Constant)
                          and isinstance(right.value, (int, float, str)))
        if isinstance(right, ast.Attribute):
            self._rule_attribute(right, is_formula)
        elif not right_is_const:
            _fail("the right-hand side of a comparison must be a number, "
                  "a string or a label identifier", right)

    def _rule_attribute(self, node, is_formula):
        if not isinstance(node.value, ast.Name):
            _fail("", node)
        identifier = node.value.id + "." + node.attr
        if not self.is_valid_identifier(identifier):
            _fail("'" + identifier + "' is not a valid label identifier", node)

    _FORMULA_RULES = {
        ast.Constant: _rule_constant,
        ast.BinOp: _rule_binop,
        ast.UnaryOp: _rule_unary,
        ast.Attribute: _rule_attribute,
    }
    _CONDITION_RULES = {
        ast.UnaryOp: _rule_unary,
        ast.Compare: _rule_compare,
        ast.BoolOp: _rule_boolop,
    }
